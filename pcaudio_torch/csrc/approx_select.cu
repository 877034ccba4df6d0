// Kernel K2a: approximate per-row top-K by window maxima.
//
// Replaces no Pallas kernel.  It replaces XLA's TPU ApproxTopK, which the
// JAX package reaches through lax.approx_max_k in its serving pipeline
// (pcaudio/eval/pipeline.py:134 on the "xla" featurize path, :217 on the
// fused one) when extraction="approx".  What it computes is XLA's plan,
// not a recall: the N keys of a row are max-reduced into M windows of 2^r
// keys, (M, r) from the recall target (ops/kernels/approx_select.py::
// approx_topk_plan, a copy of XLA's ApproxTopKReductionOutputSize), and
// the exact top K of the M window maxima is taken.  Window w holds the
// keys w, w + M, w + 2M, ... (the elementwise max of the 2^r slabs of M
// keys; no run can show which assignment the TPU uses: the strided one is
// the port's choice).  A tie inside a window goes to the lower slab, a tie
// between windows to the lower window; -0.0 ties with 0.0.  Keys are
// signed (the "xla" path selects on log-magnitudes), bf16 or f32, and not
// NaN.  Output: the K (value, flat index) pairs in ascending flat-index
// order, as K2 returns them.
//
// What bounds it on the H100: the row is read once (10 KB for a bf16
// 10 x 512 chunk) and K (value, index) pairs written, 0.148 ms at 3.35
// TB/s for the bench's 44,032 rows at K 128, K2's bound.  Its design
// follows K2's (select.cu), whose select it runs:
//  - persistent blocks of one warp group, as many as fit on the SMs, each
//    walking rows blockIdx.x, + gridDim.x, ...; a row comes in with one
//    1-D TMA bulk copy into the block's row buffer, whose tail up to
//    2^r · M keys holds the pad (rows whose bytes or address are not
//    16-byte multiples are loaded by the threads);
//  - each value is mapped once to its OrderedKey key, which orders signed
//    values by their IEEE bits (the map costs a few integer operations,
//    which at every read of K2's select made K2a's select to tau 2.3 times
//    K2's on the same keys, PERF.md);
//  - the window maxima from shared memory: each thread takes a 16-byte
//    word of windows and walks the 2^r slabs, keeping each window's
//    largest key and its slab (two bf16 keys a 32-bit word with SIMD
//    compares); keys and slabs go to buffers of their own, and the next
//    row's copy is issued as soon as every thread is past the row buffer,
//    so it lands while this row is selected (at r = 0 the row buffer is
//    mapped in place and holds the maxima, and the copy waits for the
//    compaction, as in K2);
//  - the exact top K of the M maximum keys is K2's select (select.cuh, on
//    PlainKey); it emits the winners in window order into shared memory;
//    their values are read back from the row in device memory (L2) as they
//    are written out, so -0.0 keeps its sign;
//  - the winners come out in window order, so their place in ascending
//    flat order (slab · M + window) is the number of winners in lower slabs
//    plus the number before them in their own slab: one ballot a slab and
//    32 winners gives each slab a bitmask over the winners, and a winner's
//    place is a few popcounts of them (up to kMaxMaskSlabs slabs; plans with
//    more, K = 1 and recall targets below 0.5 at K 128, count each winner's
//    rank among the K flat indices instead).

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "select.cuh"

namespace {

namespace sel = pcaudio::sel;
using Key = sel::OrderedKey;    // each value's key, computed once
using Sel = sel::PlainKey;      // the select reads keys

constexpr int kMinBlocks = 10;                // blocks an SM: caps registers
constexpr int kMaxMaskSlabs = 16;             // slabs ordered by bitmasks
// 0: the whole kernel.  probes/k2a_stages.py builds 1 (stop after the
// load), 2 (after the window maxima), 3 (once tau is found) and 4 (after
// the compaction) to time the stages.
constexpr int kStopAfter = 0;

template <typename T>
__global__ void __launch_bounds__(sel::kThreads, kMinBlocks)
approx_topk_kernel(const T* __restrict__ keys, int R, int N, int M, int S, int K,
                   int use_tma, int row_off, int win_off, int slab_off, int list_off,
                   int out_off, float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr int V = 16 / sizeof(T);              // values a 16-byte word
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);                 // [1]
  const sel::Header sh = sel::header_at<T>(smem);
  // the row (padded to rvec words), the window maxima (the row itself at
  // r = 0), their slabs, the candidate list (list_off 0: none) and the
  // winners in window order, at the offsets the launch laid out
  T* const row = reinterpret_cast<T*>(smem + row_off);
  T* const win = reinterpret_cast<T*>(smem + win_off);
  unsigned short* const slab = reinterpret_cast<unsigned short*>(smem + slab_off);
  unsigned short* const list = reinterpret_cast<unsigned short*>(smem + list_off);
  // the winners in window order: flat indices, slabs; then the slabs'
  // bitmasks over them, kw words a slab
  const int kw = (K + 31) / 32;
  int* const win_i = reinterpret_cast<int*>(smem + out_off);
  unsigned short* const win_s = reinterpret_cast<unsigned short*>(win_i + K);
  unsigned* const masks = reinterpret_cast<unsigned*>(smem + out_off + ((size_t)K * 6 + 15) / 16 * 16);
  const bool use_list = list_off > 0, windows = S > 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x;
  const int nmine = (R - (int)blockIdx.x + G - 1) / G;   // this block's rows
  const unsigned row_bytes = (unsigned)N * sizeof(T);
  const int nvec = (M + V - 1) / V;                       // words of maxima
  const int rvec = windows ? S * M / V : nvec;            // words of the row
  // warp w's quarter of the maxima: words [v_lo, v_hi), keys [seg, seg_end)
  const int per_warp = (nvec + sel::kWarps - 1) / sel::kWarps;
  const int v_lo = min(nvec, warp * per_warp), v_hi = min(nvec, v_lo + per_warp);
  const int seg = min(M, v_lo * V), seg_end = min(M, v_hi * V);
  const int r = K <= sel::kThreads ? 1 : 2;
  int s = 1;
  while (r == 1 && s < 32 && sel::kThreads / (2 * s) >= K) s *= 2;

  for (int i = tid; i < 2 * sel::hist_words<T>(); i += sel::kThreads) sh.hist[i] = 0u;
  // the row buffer's tail past N: the pad, which no copy overwrites
  for (int i = N + tid; i < rvec * V; i += sel::kThreads) row[i] = Key::pad<T>();
  if (tid == 0) {
    sel::mbar_init(full);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int j) {   // thread 0: row j of this block's walk
    sel::bulk_load(row, keys + ((size_t)blockIdx.x + (size_t)j * G) * N, row_bytes, full);
  };
  if (use_tma && tid == 0) issue(0);

  int g = 0;   // histogram passes so far: pass g counts into hist[g % 3]
  for (int j = 0; j < nmine; ++j) {
    const size_t c = (size_t)blockIdx.x + (size_t)j * G;
    const bool fetch_next = use_tma && j + 1 < nmine;
    if (use_tma) {
      sel::mbar_wait(full, (unsigned)j & 1u);
    } else {
      __syncthreads();   // the previous row's readers are done with the buffer
      const T* src = keys + c * N;
      for (int i = tid; i < N; i += sel::kThreads) row[i] = src[i];
      __syncthreads();
    }
    if (kStopAfter == 1) {
      __syncthreads();
      if (tid == 0 && fetch_next) issue(j + 1);
      continue;
    }

    // ---- the keys, and the window maxima: window w's largest key over the
    // slabs, the lower slab on a tie (slab 0 always lies in the row: M <= N)
    if (windows) {
      const uint4* rw = reinterpret_cast<const uint4*>(row);
      uint4* ww = reinterpret_cast<uint4*>(win);
      for (int v = tid; v < nvec; v += sel::kThreads) {
        uint4 best = rw[v], at = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (sizeof(T) == 2) {
#pragma unroll
          for (int w = 0; w < 4; ++w) (&best.x)[w] = Key::keys2((&best.x)[w]);
          for (int sl = 1; sl < S; ++sl) {
            const uint4 q = rw[sl * nvec + v];   // slab sl starts at word sl · M / V
            const unsigned pair = (unsigned)sl * 0x00010001u;
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const unsigned k2 = Key::keys2((&q.x)[w]);
              const unsigned up = __vcmpgtu2(k2, (&best.x)[w]);
              (&best.x)[w] = __vmaxu2(k2, (&best.x)[w]);
              (&at.x)[w] = ((&at.x)[w] & ~up) | (pair & up);
            }
          }
          reinterpret_cast<uint4*>(slab)[v] = at;
        } else {
#pragma unroll
          for (int w = 0; w < 4; ++w) (&best.x)[w] = Key::key((&best.x)[w]);
          for (int sl = 1; sl < S; ++sl) {
            const uint4 q = rw[sl * nvec + v];
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const unsigned k = Key::key((&q.x)[w]);
              if (k > (&best.x)[w]) {
                (&best.x)[w] = k;
                (&at.x)[w] = (unsigned)sl;
              }
            }
          }
          reinterpret_cast<uint2*>(slab)[v] = make_uint2(at.x | at.y << 16, at.z | at.w << 16);
        }
        ww[v] = best;
      }
      __syncthreads();
      if (fetch_next && tid == 0) issue(j + 1);   // the row buffer is free
    } else {   // r = 0: the row's keys in place, key 0 past N
      uint4* rw = reinterpret_cast<uint4*>(row);
      for (int v = tid; v < nvec; v += sel::kThreads) {
        uint4 q = rw[v];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          unsigned k = sizeof(T) == 2 ? Key::keys2((&q.x)[w]) : Key::key((&q.x)[w]);
          const int e = v * V + w * (V / 4);   // the word's first element
          if (sizeof(T) == 2) {
            if (e >= N) k &= 0xffff0000u;
            if (e + 1 >= N) k &= 0x0000ffffu;
          } else if (e >= N) {
            k = 0u;
          }
          (&q.x)[w] = k;
        }
        rw[v] = q;
      }
      __syncthreads();
    }
    if (kStopAfter == 2) {
      if (!windows && tid == 0 && fetch_next) issue(j + 1);
      continue;
    }

    // ---- the exact top K of the M maxima: K2's select on ordered keys
    const uint4* words = reinterpret_cast<const uint4*>(win);
    unsigned t0, kmax;
    sel::key_bounds<T, Sel>(words, nvec, r, s, use_list, sh, &t0, &kmax);
    const bool flat = t0 == kmax;   // every maximum <= t0: the first K equal to it
    int n = seg_end - seg;
    if (use_list && !flat) n = sel::list_candidates<T, Sel>(words, v_lo, v_hi, seg, M, t0, list);
    int need;
    const unsigned tau = sel::radix_tau<T, Sel>(win, list, use_list, seg, n, t0, kmax, K,
                                               sh.hist, g, &need);
    if (kStopAfter == 3) {
      if (tau == 0xffffffffu && tid == 0) out_i[c * K] = need;   // keeps tau live
      __syncthreads();
      if (!windows && fetch_next && tid == 0) issue(j + 1);
      continue;
    }
    auto emit = [&](int p, int w, T) {
      const int at = windows ? (int)slab[w] : 0;
      win_i[p] = at * M + w;
      win_s[p] = (unsigned short)at;
    };
    if (flat)
      sel::take_first_equal<T, Sel>(win, M, K, tau, emit);
    else
      sel::compact<T, Sel>(win, list, use_list, seg, n, tau, need, sh.wcount, emit);
    __syncthreads();
    if (!windows && fetch_next && tid == 0) issue(j + 1);   // r = 0: win is the row
    if (kStopAfter == 4) continue;

    // ---- ascending flat order, each value read from the row as it came
    const T* const src = keys + c * N;
    float* const ov = out_v + c * K;
    int* const oi = out_i + c * K;
    if (S <= kMaxMaskSlabs) {
      // slab sl's bitmask over the winners, 32 winners a word
      for (int cw = warp; cw < kw; cw += sel::kWarps) {
        const int p = cw * 32 + lane;
        const int at = p < K ? (int)win_s[p] : -1;
        for (int sl = 0; sl < S; ++sl) {
          const unsigned b = __ballot_sync(pcaudio::kFullMask, at == sl);
          if (lane == 0) masks[sl * kw + cw] = b;
        }
      }
      __syncthreads();
      for (int p = tid; p < K; p += sel::kThreads) {
        const int at = win_s[p], cw = p >> 5;
        int place = __popc(masks[at * kw + cw] & ((1u << (p & 31)) - 1u));
        for (int i = 0; i < at * kw + cw; ++i) place += __popc(masks[i]);
        const int f = win_i[p];
        ov[place] = sel::value_of(__ldg(src + f));
        oi[place] = f;
      }
    } else {   // a winner's place is its rank among the K distinct flat indices
      for (int p = tid; p < K; p += sel::kThreads) {
        const int f = win_i[p];
        int rank = 0;
        for (int q = 0; q < K; ++q) rank += win_i[q] < f;
        ov[rank] = sel::value_of(__ldg(src + f));
        oi[rank] = f;
      }
    }
  }
}

size_t round16(size_t n) { return (n + 15) / 16 * 16; }

template <typename T>
int launch(const T* keys, void* vals, void* idx, int R, int N, int M, int S, int K,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const size_t head = sel::header_bytes<T>();
  // at r > 0 the row buffer holds 2^r · M keys (M a multiple of 128), at
  // r = 0 the row and the maxima are one buffer of M = N keys
  const size_t row = round16((size_t)(S > 1 ? S * M : M) * sizeof(T));
  const size_t win = S > 1 ? round16((size_t)M * sizeof(T)) : 0;
  const size_t slabs = S > 1 ? round16((size_t)M * 2) : 0;
  const size_t list = round16((size_t)M * 2);
  const size_t outs = round16((size_t)K * 6) + (size_t)kMaxMaskSlabs * ((K + 31) / 32) * 4;
  size_t smem = head + row + win + slabs + outs;
  if (smem > (size_t)sel::kSmemMax || (S > 1 && M % V != 0))
    return (int)cudaErrorInvalidValue;
  // candidates listed where K allows a bound (K <= 256) and the list fits
  const bool use_list = K <= 2 * sel::kThreads && smem + list <= (size_t)sel::kSmemMax;
  if (use_list) smem += list;
  const size_t win_off = S > 1 ? head + row : head;
  const size_t slab_off = head + row + win, list_off = slab_off + slabs;
  const size_t out_off = list_off + (use_list ? list : 0);
  const bool tma = (size_t)N * sizeof(T) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  int per_sm = 0, sms = 0;
  const cudaError_t e = sel::occupancy(approx_topk_kernel<T>, smem, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)((long long)per_sm * sms < R ? (long long)per_sm * sms : R);
  approx_topk_kernel<T><<<grid, sel::kThreads, smem, stream>>>(
      keys, R, N, M, S, K, (int)tma, (int)head, (int)win_off, S > 1 ? (int)slab_off : 0,
      use_list ? (int)list_off : 0, (int)out_off, (float*)vals, (int*)idx);
  return (int)cudaGetLastError();
}

}  // namespace

// keys [R, N] (bf16 when keys_bf16, else f32) -> vals [R, K] f32, idx [R, K]
// int32; M windows of 2^r slabs, as approx_topk_plan gives them
extern "C" int pcaudio_approx_topk(const void* keys, int keys_bf16, void* vals, void* idx,
                                   int R, int N, int M, int r, int K, void* stream) {
  if (R < 1 || N < 1 || N > sel::kMaxChunk || r < 0 || r > 16 || M < 1 || M > N ||
      K < 1 || K > M || ((long long)M << r) < N)
    return (int)cudaErrorInvalidValue;
  const int S = 1 << r;
  const cudaStream_t st = (cudaStream_t)stream;
  if (keys_bf16)
    return launch(static_cast<const unsigned short*>(keys), vals, idx, R, N, M, S, K, st);
  return launch(static_cast<const unsigned*>(keys), vals, idx, R, N, M, S, K, st);
}
