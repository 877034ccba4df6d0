// Kernel K2: exact per-chunk top-K of non-negative magnitudes.
//
// Replaces the Pallas kernel pcaudio/ops/kernels/select.py::
// exact_topk_chunks (`_kernel` with `_compact_gather` or the one-hot
// scatter).  The selected set is lax.top_k's over the row-major flattening
// of each chunk (ties go to the first in flat order), returned in ascending
// flat-index order.
//
// Keys.  A value's key is its IEEE bit pattern (16 bits for bf16, 32 for
// f32) with the sign cleared: for non-negative values the keys order
// like the values, and -0.0 gets the key of 0.0, so it ties with 0.0 in
// flat order as the JAX kernel's value comparisons make it.  Comparing
// keys is exact for subnormals too.
//
// The select itself (the bound, the candidate lists, the radix search of
// tau and the compaction) lives in select.cuh, where kernel K2a
// (approx_select.cu) runs it on its window maxima under a key map for
// signed values; this file holds K2's load and its walk over the chunks.
//
// What bounds it on the H100: the chunk is read once (10 KB for a bf16
// 10 x 512 chunk) and K (value, index) pairs written, 0.148 ms at 3.35 TB/s
// for the bench's 44,032 chunks at K 128.  Everything else runs in shared
// memory, so the design is about issue slots, latency and hiding the loads
// (probes/k2_stages.py splits this design and the one before it by stage):
//
//  - persistent blocks of one warp group (128 threads) a chunk, as many as
//    fit on the SMs, each walking chunks blockIdx.x, + gridDim.x, ...; a
//    chunk comes in with one 1-D TMA bulk copy (cp.async.bulk + an
//    mbarrier) into the block's one buffer, issued once the block is done
//    with the chunk before: the other resident blocks hide its latency (a
//    ring of two buffers measured slower at the bench shape, where it costs
//    resident blocks).  Chunks whose byte size or address is not a multiple
//    of 16 are loaded by the block's threads;
//  - a lower bound t0 <= tau prunes the keys: the least over the block of
//    the largest key of each group of s threads (128 / s >= K groups, each
//    holding a key >= t0), or for K <= 256 of each thread's second largest
//    key, read with 16-bit SIMD max/min for bf16.  On the bench's noise
//    about one key in nine is >= t0.  The same read gives the largest key
//    kmax.  Each warp lists the flat indices of its quarter's candidates
//    (keys >= t0), in flat order, found a warp-stripe of lane-contiguous
//    16-byte words at a time (no bank conflicts) with one warp scan;
//  - tau by radix select on the offsets key - t0 <= kmax - t0, 9-bit digits
//    for bf16 (8 for f32) from the top bit of kmax - t0: one pass on the
//    bench's noise, none where every key <= t0 (an all-equal chunk, or a
//    tie-heavy one), at most two for bf16.  A pass counts only the
//    candidates that match the digits found so far, into 16-bit bins two
//    a word (a chunk holds at most 57,600 keys), with one barrier: after it
//    every warp reads the bins itself and finds the same digit; three
//    histograms rotate, so one is cleared two passes before its reuse;
//  - winners (keys > tau, and the first `need` keys == tau in flat order)
//    are compacted a warp at a time over its candidates: a count, one
//    barrier for the warps' offsets, and a sweep with ballot ranks a
//    stripe; a stripe's winners go to consecutive output positions.  When
//    every key <= t0, one warp takes the first K keys equal to t0.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "select.cuh"

namespace {

using pcaudio::sel::kThreads;
using pcaudio::sel::kWarps;
using pcaudio::sel::header_bytes;
using pcaudio::sel::hist_words;
using pcaudio::sel::kSmemMax;
using pcaudio::sel::kMaxChunk;
using Key = pcaudio::sel::AbsKey;             // non-negative magnitudes
using pcaudio::sel::bulk_load;
using pcaudio::sel::mbar_init;
using pcaudio::sel::mbar_wait;

constexpr int kMinBlocks = 10;                // blocks an SM: caps registers
// 0: the whole kernel.  probes/k2_stages.py builds 1 (stop after the load)
// and 2 (stop once tau is found) to time the stages.
constexpr int kStopAfter = 0;

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
topk_chunks_kernel(const T* __restrict__ mags, int N, int L, int K, int use_tma,
                   int buf_off, int list_off, float* __restrict__ out_v,
                   int* __restrict__ out_i) {
  constexpr int V = 16 / sizeof(T);              // values a 16-byte word
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);                 // [1]
  const pcaudio::sel::Header sh = pcaudio::sel::header_at<T>(smem);
  const int nvec = (L + V - 1) / V;
  const int buf_elems = nvec * V;
  // the chunk and the candidate list (list_off 0: none) at the byte
  // offsets the launch laid out.  Offsets known only at run time keep the
  // shared-memory base in a register: at a compile-time offset ptxas
  // re-derives it (an S2R of SR_CgaCtaId) at most accesses, which is slower
  // at the bench shape (PERF.md, section 6)
  T* const buf = reinterpret_cast<T*>(smem + buf_off);
  unsigned short* const list = reinterpret_cast<unsigned short*>(smem + list_off);
  const bool use_list = list_off > 0;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int G = gridDim.x;
  const int nmine = (N - (int)blockIdx.x + G - 1) / G;   // this block's chunks
  const unsigned chunk_bytes = (unsigned)L * sizeof(T);
  // warp w's quarter of the chunk: words [v_lo, v_hi), keys [seg, seg_end)
  const int per_warp = (nvec + kWarps - 1) / kWarps;
  const int v_lo = min(nvec, warp * per_warp), v_hi = min(nvec, v_lo + per_warp);
  const int seg = min(L, v_lo * V), seg_end = min(L, v_hi * V);
  // t0 <= tau: the least over the block of the largest key of each group of
  // s threads (128 / s >= K groups), or for K up to 256 of the threads'
  // second largest keys
  const int r = K <= kThreads ? 1 : 2;
  int s = 1;
  while (r == 1 && s < 32 && kThreads / (2 * s) >= K) s *= 2;

  for (int i = tid; i < 2 * hist_words<T>(); i += kThreads) sh.hist[i] = 0u;
  if (tid == 0) {
    mbar_init(full);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int j) {   // thread 0: chunk j of this block's walk
    bulk_load(buf, mags + ((size_t)blockIdx.x + (size_t)j * G) * L, chunk_bytes, full);
  };
  if (use_tma && tid == 0) issue(0);

  int g = 0;   // histogram passes so far: pass g counts into hist[g % 3]
  for (int j = 0; j < nmine; ++j) {
    const size_t c = (size_t)blockIdx.x + (size_t)j * G;
    // chunk j+1 goes into buf once every thread is done with chunk j
    const bool fetch_next = use_tma && j + 1 < nmine;
    if (use_tma) {
      mbar_wait(full, (unsigned)j & 1u);
    } else {
      __syncthreads();   // the previous chunk's readers are done with buf
      const T* src = mags + c * L;
      for (int i = tid; i < L; i += kThreads) buf[i] = src[i];
      for (int i = L + tid; i < buf_elems; i += kThreads) buf[i] = Key::pad<T>();
      __syncthreads();
    }
    if (kStopAfter == 1) {
      __syncthreads();
      if (tid == 0 && fetch_next) issue(j + 1);
      continue;
    }
    const uint4* words = reinterpret_cast<const uint4*>(buf);

    // ---- the chunk's largest key kmax and the bound t0 (0 without a list:
    // then every key is a candidate)
    unsigned t0, kmax;
    pcaudio::sel::key_bounds<T, Key>(words, nvec, r, s, use_list, sh, &t0, &kmax);
    // every key <= t0 = kmax: tau = t0, and the winners are the first K keys
    // equal to it (an all-equal chunk: empty, silent or tie-heavy)
    const bool flat = t0 == kmax;
    int n = seg_end - seg;   // this warp's candidates
    if (use_list && !flat)   // the warp's candidates (keys >= t0) in flat order
      n = pcaudio::sel::list_candidates<T, Key>(words, v_lo, v_hi, seg, L, t0, list);

    // ---- radix select of tau on the offsets key - t0 <= kmax - t0
    int need;   // keys == tau to take; keys > tau number K - need
    const unsigned tau = pcaudio::sel::radix_tau<T, Key>(buf, list, use_list, seg, n, t0,
                                                         kmax, K, sh.hist, g, &need);
    if (kStopAfter == 2) {
      if (tau == 0xffffffffu && tid == 0) out_i[c * K] = need;   // keeps tau live
      if (fetch_next) {
        __syncthreads();
        if (tid == 0) issue(j + 1);
      }
      continue;
    }

    // ---- compaction in flat order: every key >= tau is a candidate ----------
    float* ov = out_v + c * K;
    int* oi = out_i + c * K;
    auto emit = [&](int p, int i, T raw) {
      ov[p] = pcaudio::sel::value_of(raw);
      oi[p] = i;
    };
    if (flat)
      pcaudio::sel::take_first_equal<T, Key>(buf, L, K, tau, emit);
    else
      pcaudio::sel::compact<T, Key>(buf, list, use_list, seg, n, tau, need, sh.wcount, emit);
    if (fetch_next) {
      __syncthreads();
      if (tid == 0) issue(j + 1);
    }
  }
}

template <typename T>
int launch(const T* mags, void* vals, void* idx, int N, int L, int K,
           cudaStream_t stream) {
  const size_t bytes = (size_t)L * sizeof(T);
  const size_t buf = (bytes + 15) / 16 * 16;
  const size_t list = ((size_t)L * 2 + 15) / 16 * 16;
  const bool tma = bytes % 16 == 0 && reinterpret_cast<uintptr_t>(mags) % 16 == 0;
  constexpr size_t kHeader = header_bytes<T>();
  auto fits = [](size_t n) { return kHeader + n <= (size_t)kSmemMax; };
  if (!fits(buf)) return (int)cudaErrorInvalidValue;
  // candidates listed where K allows a bound (K <= 256) and the list fits
  const size_t extra = K <= 2 * kThreads && fits(buf + list) ? list : 0;
  const size_t smem = kHeader + buf + extra;
  int per_sm = 0, sms = 0;
  const cudaError_t e = pcaudio::sel::occupancy(topk_chunks_kernel<T>, smem, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)((long long)per_sm * sms < N ? (long long)per_sm * sms : N);
  topk_chunks_kernel<T><<<grid, kThreads, smem, stream>>>(
      mags, N, L, K, (int)tma, (int)kHeader, extra > 0 ? (int)(kHeader + buf) : 0,
      (float*)vals, (int*)idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pcaudio_topk_chunks(const void* mags, int mags_bf16, void* vals,
                                   void* idx, int N, int L, int K, void* stream) {
  if (N < 1 || L < 1 || L > kMaxChunk || K < 1 || K > L)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (mags_bf16)
    return launch(static_cast<const unsigned short*>(mags), vals, idx, N, L, K, st);
  return launch(static_cast<const unsigned*>(mags), vals, idx, N, L, K, st);
}
