// The device-side exact select of kernel K2 (csrc/select.cu), shared with
// kernel K2a (csrc/approx_select.cu): the top K of L keys that lie in a
// block's shared memory, ties to the first in order, found by one warp
// group (128 threads).  csrc/select.cu's head comment describes the method:
// a bound t0 <= tau from the threads' largest keys, a per-warp candidate
// list (keys >= t0) in order, tau by radix select on key - t0, and the
// winners compacted in order with ballot ranks.
//
// Keys.  The select orders raw values (bf16 or f32 bit patterns) by the key
// a map gives them, an unsigned integer:
//  - AbsKey (K2): the bit pattern with the sign cleared, which orders
//    non-negative values like the values and gives -0.0 the key of 0.0;
//  - OrderedKey (K2a): the IEEE order of signed values, -inf lowest (the
//    sign bit flipped for non-negative values, every bit for negative
//    ones), with -0.0 given the key of 0.0;
//  - PlainKey: keys that are already keys (K2a maps each value once with
//    OrderedKey and selects on the result: a map costs a few integer
//    operations at every one of the select's reads).
// AbsKey and OrderedKey have a pad value whose key is 0, the lowest: the
// tail of a 16-byte word past the L keys holds it, so it never raises a
// bound (PlainKey's pad is the key 0 itself).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "common.cuh"

namespace pcaudio {
namespace sel {

constexpr int kThreads = 128;                 // one warp group a select
constexpr int kWarps = kThreads / 32;
// radix digits: 9 bits for bf16's keys (one pass on the bench's noise),
// 8 for f32, whose largest chunk (57,600 keys, 230,400 bytes) leaves room
// for three 256-bin histograms only; 16-bit bins, two a word
template <typename T>
__host__ __device__ constexpr int digit_bits() { return sizeof(T) == 2 ? 9 : 8; }
template <typename T>
__host__ __device__ constexpr int hist_words() { return (1 << digit_bits<T>()) / 2; }
// 16 bytes the caller may use (K2's mbarrier), three histograms, and the
// warps' minima, maxima and winner counts
template <typename T>
__host__ __device__ constexpr int header_bytes() {
  return 16 + 3 * hist_words<T>() * 4 + 4 * kWarps * 4;
}
constexpr int kSmemMax = 227 * 1024;          // shared memory a block can use
constexpr int kMaxChunk = 57600;              // bins count up to 65,535 keys

static_assert(header_bytes<unsigned short>() % 16 == 0 && header_bytes<unsigned>() % 16 == 0,
              "the buffers after the header must stay 16-byte aligned");

struct AbsKey {
  __device__ __forceinline__ static unsigned key(unsigned short r) { return r & 0x7fffu; }
  __device__ __forceinline__ static unsigned key(unsigned r) { return r & 0x7fffffffu; }
  // the keys of the two bf16 values of a 32-bit word, one a half
  __device__ __forceinline__ static unsigned keys2(unsigned w) { return w & 0x7fff7fffu; }
  template <typename T>
  __device__ __forceinline__ static T pad() { return (T)0; }
};

struct OrderedKey {
  __device__ __forceinline__ static unsigned key(unsigned short r) {
    const unsigned x = r == 0x8000u ? 0u : r;
    return x & 0x8000u ? ~x & 0xffffu : x | 0x8000u;
  }
  __device__ __forceinline__ static unsigned key(unsigned r) {
    const unsigned x = r == 0x80000000u ? 0u : r;
    return x & 0x80000000u ? ~x : x | 0x80000000u;
  }
  __device__ __forceinline__ static unsigned keys2(unsigned w) {
    const unsigned z = w & ~__vcmpeq2(w, 0x80008000u);   // -0.0 halves to 0.0
    const unsigned s = (z >> 15) & 0x00010001u;           // the halves' signs
    return z ^ (s * 0x7fffu | 0x80008000u);
  }
  template <typename T>
  __device__ __forceinline__ static T pad() { return (T)~(T)0; }   // key 0
};

// keys stored as they order (K2a maps each key once, with OrderedKey)
struct PlainKey {
  __device__ __forceinline__ static unsigned key(unsigned short r) { return r; }
  __device__ __forceinline__ static unsigned key(unsigned r) { return r; }
  __device__ __forceinline__ static unsigned keys2(unsigned w) { return w; }
};

// ---- the load: one 1-D TMA bulk copy into shared memory ---------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One thread: copy `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory; `bar` completes when they land.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  // the buffer was last read through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Blocks of `kernel` an SM holds at `smem` bytes of dynamic shared memory,
// and the device's SMs: one occupancy query per (device, kernel, smem),
// kept, so a serving launch makes no query after its shape's first call.
// The kernel's shared-memory attribute is raised to the largest size asked
// on the device (it only grows: a larger launch may be in flight).
struct Occupancy {
  int dev;
  const void* kernel;
  size_t smem;
  int per_sm, sms;
};

template <typename Kernel>
cudaError_t occupancy(Kernel kernel, size_t smem, int* per_sm, int* sms) {
  static std::mutex mu;
  static Occupancy table[64];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const std::lock_guard<std::mutex> lock(mu);
  size_t top = smem;
  for (int i = 0; i < used; ++i) {
    if (table[i].dev != dev || table[i].kernel != fn) continue;
    if (table[i].smem == smem) {
      *per_sm = table[i].per_sm;
      *sms = table[i].sms;
      return cudaSuccess;
    }
    top = table[i].smem > top ? table[i].smem : top;
  }
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)top)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
  if (e == cudaSuccess && used < 64) table[used++] = {dev, fn, smem, *per_sm, *sms};
  return e;
}

// ---- the select ---------------------------------------------------------------

// element e of a 16-byte word of raw values
template <typename T>
__device__ __forceinline__ T raw_at(const uint4& q, int e) {
  if (sizeof(T) == 2) {
    const unsigned w = (&q.x)[e >> 1];
    return (T)((e & 1) ? w >> 16 : w & 0xffffu);
  }
  return (T)(&q.x)[e];
}

__device__ __forceinline__ float value_of(unsigned short r) {
  return __uint_as_float((unsigned)r << 16);
}
__device__ __forceinline__ float value_of(unsigned r) { return __uint_as_float(r); }

// a thread's largest and r-th largest key (r = 1 or 2) from its running
// largest `a` and second largest `b`; bf16 tracks both 16-bit halves apart
__device__ __forceinline__ void thread_keys(unsigned a, unsigned b, int r, bool halves,
                                            unsigned* top, unsigned* rth) {
  if (!halves) {
    *top = a;
    *rth = r == 1 ? a : b;
    return;
  }
  const unsigned alo = a & 0xffffu, ahi = a >> 16, blo = b & 0xffffu, bhi = b >> 16;
  *top = max(alo, ahi);
  *rth = r == 1 ? *top : max(min(alo, ahi), max(blo, bhi));
}

// The select's bookkeeping, after the caller's first 16 bytes of `smem`.
struct Header {
  unsigned* hist;   // [3][hist_words]: rotating radix histograms
  unsigned* wmin;   // [kWarps]: the warps' bounds
  unsigned* wmax;   // [kWarps]: the warps' largest keys
  int* wcount;      // [2 kWarps]: the warps' keys above tau, and equal to it
};

template <typename T>
__device__ __forceinline__ Header header_at(unsigned char* smem) {
  Header h;
  h.hist = reinterpret_cast<unsigned*>(smem + 16);
  h.wmin = h.hist + 3 * hist_words<T>();
  h.wmax = h.wmin + kWarps;
  h.wcount = reinterpret_cast<int*>(h.wmax + kWarps);
  return h;
}

// The whole block: the largest key of the nvec words and t0 <= tau, the
// least over the block of the largest key of each group of s threads
// (128 / s >= K groups), or for K up to 256 (r = 2) of the threads' second
// largest keys; t0 = 0 without a candidate list (every key a candidate).
// Ends with a barrier, after which every thread holds both.
template <typename T, typename Map>
__device__ __forceinline__ void key_bounds(const uint4* words, int nvec, int r, int s,
                                           bool use_list, const Header& h,
                                           unsigned* t0_out, unsigned* kmax_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned a = 0, b = 0;
  for (int v = tid; v < nvec; v += kThreads) {   // the tail past L holds the pad
    const uint4 q = words[v];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (sizeof(T) == 2) {
        const unsigned k2 = Map::keys2((&q.x)[w]);   // two keys
        b = __vmaxu2(b, __vminu2(a, k2));
        a = __vmaxu2(a, k2);
      } else {
        const unsigned k = Map::key((&q.x)[w]);
        b = max(b, min(a, k));
        a = max(a, k);
      }
    }
  }
  unsigned top, t0;
  thread_keys(a, b, r, sizeof(T) == 2, &top, &t0);
  for (int o = 1; o < s; o <<= 1) t0 = max(t0, __shfl_xor_sync(kFullMask, t0, o));
  t0 = use_list ? __reduce_min_sync(kFullMask, t0) : 0u;
  top = __reduce_max_sync(kFullMask, top);
  if (lane == 0) {
    h.wmin[warp] = t0;
    h.wmax[warp] = top;
  }
  __syncthreads();
  unsigned kmax = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    t0 = min(t0, h.wmin[w]);
    kmax = max(kmax, h.wmax[w]);
  }
  *t0_out = t0;
  *kmax_out = kmax;
}

// One warp: the positions of its candidates (keys >= t0) among words
// [v_lo, v_hi), in order, at list[seg ...]; returns their number.
template <typename T, typename Map>
__device__ __forceinline__ int list_candidates(const uint4* words, int v_lo, int v_hi,
                                               int seg, int L, unsigned t0,
                                               unsigned short* list) {
  constexpr int V = 16 / sizeof(T);              // values a 16-byte word
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int v0 = v_lo; v0 < v_hi; v0 += 32) {
    const int v = v0 + lane;
    const uint4 q = v < v_hi ? words[v] : make_uint4(0u, 0u, 0u, 0u);
    unsigned bits = 0;
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (v < v_hi && v * V + e < L && Map::key(raw_at<T>(q, e)) >= t0) bits |= 1u << e;
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += y;
    }
    int p = seg + n + incl - cnt;
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (bits >> e & 1u) list[p++] = (unsigned short)(v * V + e);
    n += __shfl_sync(kFullMask, incl, 31);
  }
  __syncwarp();
  return n;
}

// candidate i of a warp: its list entry, or position seg + i without a list
__device__ __forceinline__ int candidate(const unsigned short* list, bool use_list, int seg,
                                         int i) {
  return use_list ? (int)list[seg + i] : seg + i;
}

// The whole block: tau, the K-th largest key, by radix select on the
// offsets key - t0 <= kmax - t0 of each warp's n candidates, digits from
// the top bit of kmax - t0 (no pass when every candidate equals t0: an
// all-equal chunk, or a tie-heavy one).  Pass g counts into hist[g % 3]
// and clears hist[(g + 2) % 3]; the caller zeroes hist[0] and hist[1]
// before its first select.  *need: the keys equal to tau to take (keys
// above tau number K - *need).
template <typename T, typename Map>
__device__ __forceinline__ unsigned radix_tau(const T* buf, const unsigned short* list,
                                              bool use_list, int seg, int n, unsigned t0,
                                              unsigned kmax, int K, unsigned* hist, int& g,
                                              int* need) {
  constexpr int kHistWords = hist_words<T>(), kBins = 2 * kHistWords;
  constexpr int kLaneWords = kHistWords / 32;    // a lane's bins in the search
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_pad = (n + 31) & ~31;
  unsigned prefix = 0, known = 0;   // offset digits found so far, their bits
  int krem = K;                     // rank of tau among the matching keys
  for (int shift = 32 - __clz(kmax - t0); shift > 0; ++g) {
    const int lo = max(0, shift - digit_bits<T>());
    const unsigned dmask = (1u << (shift - lo)) - 1u;
    unsigned* h = hist + (g % 3) * kHistWords;
    for (int i = lane; i < n_pad; i += 32) {
      if (i >= n) continue;
      const unsigned o = Map::key(buf[candidate(list, use_list, seg, i)]) - t0;
      if ((o & known) == prefix) {
        const unsigned d = (o >> lo) & dmask;
        atomicAdd(&h[d >> 1], 1u << ((d & 1u) * 16));
      }
    }
    __syncthreads();
    // hist[(g + 2) % 3] was last read in pass g - 1, before this barrier,
    // and is next counted into after the next pass's barrier
    for (int i = tid; i < kHistWords; i += kThreads)
      hist[((g + 2) % 3) * kHistWords + i] = 0u;
    // every warp finds the digit holding tau: lane l holds the 2 kLaneWords
    // bins below kBins - 2 kLaneWords l, counted from the top
    const uint4* h4 = reinterpret_cast<const uint4*>(h);
    unsigned cnt[2 * kLaneWords];
#pragma unroll
    for (int q = 0; q < kLaneWords / 4; ++q) {
      const uint4 u = h4[kHistWords / 4 - 1 - (kLaneWords / 4) * lane - q];
      const unsigned w[4] = {u.w, u.z, u.y, u.x};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        cnt[8 * q + 2 * x] = w[x] >> 16;
        cnt[8 * q + 2 * x + 1] = w[x] & 0xffffu;
      }
    }
    int local = 0;
#pragma unroll
    for (int e = 0; e < 2 * kLaneWords; ++e) local += (int)cnt[e];
    int incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += y;
    }
    int above = incl - local;   // keys in the bins above my first
    const bool mine = above < krem && krem <= incl;
    int digit = 0, nk = 0;
    bool found = false;
#pragma unroll
    for (int e = 0; e < 2 * kLaneWords; ++e) {
      if (mine && !found && above + (int)cnt[e] >= krem) {
        digit = kBins - 1 - 2 * kLaneWords * lane - e;
        nk = krem - above;
        found = true;
      }
      above += (int)cnt[e];
    }
    const int src = __ffs(__ballot_sync(kFullMask, mine)) - 1;
    digit = __shfl_sync(kFullMask, digit, src);
    krem = __shfl_sync(kFullMask, nk, src);
    prefix |= (unsigned)digit << lo;
    known |= dmask << lo;
    shift = lo;
  }
  *need = krem;
  return t0 + prefix;
}

// Warp 0, where every key <= t0 = kmax: the first K of the L keys equal to
// tau, emit(rank, position, raw) for each.
template <typename T, typename Map, typename Emit>
__device__ __forceinline__ void take_first_equal(const T* buf, int L, int K, unsigned tau,
                                                 Emit emit) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  int found = 0;
  for (int base = 0; found < K && base < L; base += 32) {
    const int i = base + lane;
    const T raw = i < L ? buf[i] : (T)0;
    const bool hit = i < L && Map::key(raw) == tau;
    const unsigned bits = __ballot_sync(kFullMask, hit);
    const int rank = found + __popc(bits & ((1u << lane) - 1u));
    if (hit && rank < K) emit(rank, i, raw);
    found += __popc(bits);
  }
}

// The whole block: the winners (keys > tau, and the first `need` keys ==
// tau in order) compacted a warp at a time over its n candidates: a count,
// one barrier for the warps' offsets, and a sweep with ballot ranks a
// stripe; emit(rank, position, raw) for each, ranks in order.
template <typename T, typename Map, typename Emit>
__device__ __forceinline__ void compact(const T* buf, const unsigned short* list,
                                        bool use_list, int seg, int n, unsigned tau,
                                        int need, int* wcount, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_pad = (n + 31) & ~31;
  int gt = 0, eq = 0;
  for (int i = lane; i < n; i += 32) {
    const unsigned k = Map::key(buf[candidate(list, use_list, seg, i)]);
    gt += k > tau;
    eq += k == tau;
  }
  gt = __reduce_add_sync(kFullMask, gt);
  eq = __reduce_add_sync(kFullMask, eq);
  if (lane == 0) {
    wcount[warp] = gt;
    wcount[kWarps + warp] = eq;
  }
  __syncthreads();
  int pos = 0, eq_seen = 0;
  for (int w = 0; w < warp; ++w) {
    pos += wcount[w];
    eq_seen += wcount[kWarps + w];
  }
  pos += min(eq_seen, need);
  for (int i = lane; i < n_pad; i += 32) {
    const int idx = i < n ? candidate(list, use_list, seg, i) : 0;
    const T raw = i < n ? buf[idx] : (T)0;
    const unsigned k = Map::key(raw);
    const bool is_gt = i < n && k > tau, is_eq = i < n && k == tau;
    const unsigned gt_bits = __ballot_sync(kFullMask, is_gt);
    const unsigned eq_bits = __ballot_sync(kFullMask, is_eq);
    const unsigned below = (1u << lane) - 1u;
    const int eq_rank = eq_seen + __popc(eq_bits & below);
    const int room = max(0, need - eq_seen);   // ties still to take
    if (is_gt || (is_eq && eq_rank < need))
      emit(pos + __popc(gt_bits & below) + min(__popc(eq_bits & below), room), idx, raw);
    pos += __popc(gt_bits) + min(__popc(eq_bits), room);
    eq_seen += __popc(eq_bits);
  }
}

}  // namespace sel
}  // namespace pcaudio
