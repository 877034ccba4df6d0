// Native audio ingest for pcaudio_torch: threaded PCM WAV decoding into
// padded float32 or int16 batches, and a prefetching ring that decodes
// upcoming batches while the card computes.
//
// The port's own copy of the JAX package's decoder
// (pcaudio/native/wav_loader.cpp): the same RIFF walk, sample conversions,
// channel averaging, int16 round-clamp and error codes, so both decode a
// file to the same bits.  Driven from Python through ctypes
// (pcaudio_torch/native/__init__.py) and built there with g++; it includes
// no CUDA header.
//
// Supported: RIFF/WAVE with PCM 8/16/24/32-bit and IEEE float32, any channel
// count (averaged to mono, librosa convention).  Chunk-walking parser —
// handles LIST/fact/etc. chunks in any order.
//
// One difference from the JAX package's ring: its slot buffers belong to the
// caller (pcaudio_prefetch_create takes one waves and one lengths pointer per
// slot), so Python can hand it pinned host memory that feeds an asynchronous
// host-to-device copy with no host-side copy in between.  And a slot's rows
// past the batch's file count are zeroed with length 0, so a reused slot
// carries nothing of the batch before it.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Reader {
  FILE* f;
  explicit Reader(const char* path) : f(std::fopen(path, "rb")) {}
  ~Reader() { if (f) std::fclose(f); }
  bool read(void* dst, size_t n) { return f && std::fread(dst, 1, n, f) == n; }
  bool skip(long n) { return f && std::fseek(f, n, SEEK_CUR) == 0; }
};

// Output sample traits: float staging (librosa-exact f32 in [-1, 1]) or
// int16 staging (half the host-to-device bytes; bit-exact for 16-bit PCM
// sources and round-clamped for wider or float sources, up to 1/65536 a
// sample).
template <typename T>
struct SampleOut;
template <>
struct SampleOut<float> {
  static float from_f(float v) { return v; }
  static float from_i16(int16_t s) { return (float)s / 32768.0f; }
};
template <>
struct SampleOut<int16_t> {
  static int16_t from_f(float v) {
    float x = v * 32768.0f;
    if (x > 32767.0f) x = 32767.0f;
    if (x < -32768.0f) x = -32768.0f;
    return (int16_t)(x < 0 ? x - 0.5f : x + 0.5f);
  }
  static int16_t from_i16(int16_t s) { return s; }
};

// Decode one WAV file into out[0..max_len); returns the number of mono
// samples decoded (clamped to max_len), or a negative error code:
// -1 cannot open, -2 not RIFF/WAVE, -3 truncated chunk list, -4 data before
// fmt or a bad fmt, -5 truncated data, -6 unsupported sample width.
template <typename T>
int decode_one(const char* path, T* out, int64_t max_len) {
  Reader r(path);
  if (!r.f) return -1;

  char magic[4];
  uint32_t riff_size;
  if (!r.read(magic, 4) || std::memcmp(magic, "RIFF", 4) != 0) return -2;
  if (!r.read(&riff_size, 4)) return -2;
  if (!r.read(magic, 4) || std::memcmp(magic, "WAVE", 4) != 0) return -2;

  uint16_t fmt = 0, channels = 0, bits = 0;
  bool have_fmt = false;
  while (true) {
    char id[4];
    uint32_t size;
    if (!r.read(id, 4) || !r.read(&size, 4)) return -3;
    if (std::memcmp(id, "fmt ", 4) == 0) {
      uint8_t buf[16];
      if (size < 16 || !r.read(buf, 16)) return -3;
      fmt = (uint16_t)(buf[0] | buf[1] << 8);
      channels = (uint16_t)(buf[2] | buf[3] << 8);
      bits = (uint16_t)(buf[14] | buf[15] << 8);
      if (size > 16 && !r.skip((long)size - 16)) return -3;
      have_fmt = true;
      if (fmt == 0xFFFE) fmt = 1;  // WAVE_FORMAT_EXTENSIBLE: treat as PCM
    } else if (std::memcmp(id, "data", 4) == 0) {
      if (!have_fmt || channels == 0) return -4;
      const int bytes_per = bits / 8;
      if (bytes_per == 0) return -4;
      const int64_t frames = size / (bytes_per * channels);
      const int64_t n = frames < max_len ? frames : max_len;
      std::vector<uint8_t> buf((size_t)(n * channels * bytes_per));
      if (!r.read(buf.data(), buf.size())) return -5;
      if (channels == 1 && bits == 16 && fmt != 3) {
        // mono 16-bit PCM fast path (the ESC-50 / common WAV case)
        const int16_t* src = (const int16_t*)buf.data();
        if (sizeof(T) == 2) {
          std::memcpy(out, src, (size_t)n * 2);
        } else {
          for (int64_t i = 0; i < n; ++i) out[i] = SampleOut<T>::from_i16(src[i]);
        }
        return (int)n;
      }
      const float inv_ch = 1.0f / channels;
      for (int64_t i = 0; i < n; ++i) {
        float acc = 0.0f;
        for (int c = 0; c < channels; ++c) {
          const uint8_t* p = &buf[(size_t)((i * channels + c) * bytes_per)];
          float v = 0.0f;
          if (fmt == 3 && bits == 32) {  // IEEE float
            float fv;
            std::memcpy(&fv, p, 4);
            v = fv;
          } else if (bits == 16) {
            int16_t s = (int16_t)(p[0] | p[1] << 8);
            v = (float)s / 32768.0f;
          } else if (bits == 32) {
            int32_t s = (int32_t)(p[0] | p[1] << 8 | p[2] << 16 |
                                  (uint32_t)p[3] << 24);
            v = (float)s / 2147483648.0f;
          } else if (bits == 24) {
            int32_t s = (int32_t)(p[0] | p[1] << 8 | p[2] << 16);
            s -= (s & 0x800000) << 1;  // sign-extend
            v = (float)s / 8388608.0f;
          } else if (bits == 8) {  // unsigned
            v = ((float)p[0] - 128.0f) / 128.0f;
          } else {
            return -6;
          }
          acc += v;
        }
        out[i] = SampleOut<T>::from_f(acc * inv_ch);
      }
      return (int)n;
    } else {
      if (!r.skip((long)size + (size & 1))) return -3;  // chunks are 2-aligned
    }
  }
}

// Decode paths[idx] into its row, zero the row's tail; a failed decode
// leaves a zero row of length 0.  Returns the decode's result.
template <typename T>
int decode_row(const char* path, T* row, int32_t* length, int64_t buffer_len) {
  int got = decode_one<T>(path, row, buffer_len);
  const int kept = got < 0 ? 0 : got;
  *length = kept;
  if (kept < buffer_len)
    std::memset(row + kept, 0, (size_t)(buffer_len - kept) * sizeof(T));
  return got;
}

}  // namespace

extern "C" {

int pcaudio_decode_wav(const char* path, float* out, int64_t max_len) {
  return decode_one<float>(path, out, max_len);
}

}  // extern "C"

namespace {

// Threaded batch decode: paths[i] -> out[i * buffer_len .. +lengths[i]),
// zero-padded to buffer_len (the buffer may be reused/uninitialized).
// Returns 0 on success, else the first nonzero error code in path order.
template <typename T>
int decode_batch(const char** paths, int n, T* out, int32_t* lengths,
                 int64_t buffer_len, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::vector<int> errs(n, 0);
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += num_threads) {
      int got = decode_row<T>(paths[i], out + (int64_t)i * buffer_len,
                              &lengths[i], buffer_len);
      if (got < 0) errs[i] = got;
    }
  };
  std::vector<std::thread> ts;
  for (int t = 1; t < num_threads; ++t) ts.emplace_back(work, t);
  work(0);
  for (auto& t : ts) t.join();
  for (int e : errs)
    if (e != 0) return e;
  return 0;
}

}  // namespace

extern "C" {

int pcaudio_decode_wav_batch(const char** paths, int n, float* out,
                             int32_t* lengths, int64_t buffer_len,
                             int num_threads) {
  return decode_batch<float>(paths, n, out, lengths, buffer_len, num_threads);
}

int pcaudio_decode_wav_batch_i16(const char** paths, int n, int16_t* out,
                                 int32_t* lengths, int64_t buffer_len,
                                 int num_threads) {
  return decode_batch<int16_t>(paths, n, out, lengths, buffer_len,
                               num_threads);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Prefetching ring: a persistent thread pool decodes submitted batches ahead
// of consumption into `depth` slots, so host decode of batch i+1 (or
// further) overlaps the card's work on batch i.
//
// C ABI (ctypes): create → submit* → (acquire → release)* → destroy.
// Jobs decode one at a time, cooperatively across all pool threads (an
// atomic row index over all `batch` rows of the slot: rows below the job's
// file count are decoded, the rest zeroed), so one batch's latency scales
// with the pool; ready order is submission order by construction.  The
// caller owns the slot buffers and must keep them alive until destroy.

namespace {

struct Prefetcher {
  int64_t buffer_len;
  int batch, depth, nthreads;
  int fmt;                                  // 0 = float32, 1 = int16
  size_t esize;                             // bytes per sample
  std::vector<uint8_t*> buf;                // depth slots, batch*L*esize
  std::vector<int32_t*> lens;               // depth slots, batch
  std::vector<int> count;                   // files in slot
  std::vector<int> err;                     // first error code of slot

  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::vector<std::string>> pending;
  std::deque<int> free_slots, ready, acquired;
  // the job currently being decoded (cooperative)
  std::vector<std::string> cur;
  int cur_slot = -1;
  std::atomic<int> cur_next{0}, cur_done{0};
  bool stop = false;
  std::vector<std::thread> threads;

  Prefetcher(int64_t L, int b, int d, int t, int f, void** waves,
             int32_t** lengths)
      : buffer_len(L), batch(b), depth(d), nthreads(t), fmt(f),
        esize(f == 1 ? 2 : 4), buf(d), lens(d), count(d, 0), err(d, 0) {
    for (int i = 0; i < d; ++i) {
      buf[i] = static_cast<uint8_t*>(waves[i]);
      lens[i] = lengths[i];
      free_slots.push_back(i);
    }
    for (int i = 0; i < t; ++i) threads.emplace_back(&Prefetcher::run, this);
  }

  void run() {
    while (true) {
      int slot, idx, n;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop ||
                 (cur_slot >= 0 && cur_next.load() < batch) ||
                 (cur_slot < 0 && !pending.empty() && !free_slots.empty());
        });
        if (stop) return;
        if (cur_slot < 0) {  // start the next job
          cur = std::move(pending.front());
          pending.pop_front();
          cur_slot = free_slots.front();
          free_slots.pop_front();
          cur_next.store(0);
          cur_done.store(0);
          err[cur_slot] = 0;
          count[cur_slot] = (int)cur.size();
          cv.notify_all();  // wake helpers
        }
        slot = cur_slot;
        n = (int)cur.size();
        idx = cur_next.fetch_add(1);
        if (idx >= batch) continue;  // lost the race; re-wait
      }
      // decode (or, past the job's files, zero) row `idx`, outside the lock
      uint8_t* row = buf[slot] + (size_t)idx * buffer_len * esize;
      int32_t* length = &lens[slot][idx];
      int got = 0;
      if (idx >= n) {
        *length = 0;
        std::memset(row, 0, (size_t)buffer_len * esize);
      } else if (fmt == 1) {
        got = decode_row<int16_t>(cur[idx].c_str(), (int16_t*)row, length,
                                  buffer_len);
      } else {
        got = decode_row<float>(cur[idx].c_str(), (float*)row, length,
                                buffer_len);
      }
      if (got < 0) {
        std::lock_guard<std::mutex> lk(mu);
        if (err[slot] == 0) err[slot] = got;
      }
      if (cur_done.fetch_add(1) + 1 == batch) {  // last row → slot ready
        std::lock_guard<std::mutex> lk(mu);
        ready.push_back(slot);
        cur_slot = -1;
        cur.clear();
        cv.notify_all();
      }
    }
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
      cv.notify_all();
    }
    for (auto& t : threads) t.join();
  }
};

}  // namespace

extern "C" {

// fmt: 0 = float32 slots, 1 = int16 slots.  waves[i] points at slot i's
// batch*buffer_len samples of that type, lengths[i] at its batch int32s;
// both stay the caller's and must outlive the ring.
void* pcaudio_prefetch_create(int64_t buffer_len, int batch, int depth,
                              int num_threads, int fmt, void** waves,
                              int32_t** lengths) {
  if (buffer_len <= 0 || batch <= 0 || depth <= 0) return nullptr;
  if (fmt != 0 && fmt != 1) return nullptr;
  if (!waves || !lengths) return nullptr;
  for (int i = 0; i < depth; ++i)
    if (!waves[i] || !lengths[i]) return nullptr;
  if (num_threads < 1) num_threads = 1;
  return new Prefetcher(buffer_len, batch, depth, num_threads, fmt, waves,
                        lengths);
}

int pcaudio_prefetch_submit(void* h, const char** paths, int n) {
  auto* p = static_cast<Prefetcher*>(h);
  if (!p || n < 0 || n > p->batch) return -100;
  std::vector<std::string> job(paths, paths + n);
  std::lock_guard<std::mutex> lk(p->mu);
  p->pending.push_back(std::move(job));
  p->cv.notify_all();
  return 0;
}

// Blocks until the oldest submitted batch is decoded; returns its file
// count (>= 0) and sets *slot to the slot that holds it (valid until the
// matching release), or returns a negative error code (the slot is still
// acquired and must be released).
int pcaudio_prefetch_acquire(void* h, int* slot) {
  auto* p = static_cast<Prefetcher*>(h);
  if (!p) return -100;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv.wait(lk, [&] { return !p->ready.empty(); });
  int s = p->ready.front();
  p->ready.pop_front();
  p->acquired.push_back(s);
  *slot = s;
  return p->err[s] != 0 ? p->err[s] : p->count[s];
}

// Releases the oldest acquired slot.
int pcaudio_prefetch_release(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  if (!p) return -100;
  std::lock_guard<std::mutex> lk(p->mu);
  if (p->acquired.empty()) return -101;
  p->free_slots.push_back(p->acquired.front());
  p->acquired.pop_front();
  p->cv.notify_all();
  return 0;
}

// Stops and joins the pool (each thread first finishes the row it holds).
void pcaudio_prefetch_destroy(void* h) {
  delete static_cast<Prefetcher*>(h);
}

}  // extern "C"
