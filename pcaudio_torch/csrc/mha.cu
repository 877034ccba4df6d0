// Kernel K4: trainable masked multi-head set attention, forward and backward.
//
// Replaces the Pallas kernels of pcaudio/ops/kernels/mha.py::fused_mha
// (`_fwd_kernel` under the forward's `pallas_call`, `_bwd_kernel` under the
// custom VJP `_fused_mha`):
//   out_h = softmax_j(q_h[i] . k_h[j] * scale, masked keys left out) v_h
// with feature-split heads (head h owns features [h*dh, (h+1)*dh)), the
// reference's scale 1/sqrt(dim_V) passed in, and a row whose keys are all
// masked giving a zero output and zero gradients.  Sums are f32; the TPU
// kernel's bf16 operand rounding is not carried over.
//
// Forward (redesigned for Hopper: `mha_fwd_kernel`, `mha_fwd_short_kernel`
// and `mha_fwd_merge_kernel`).  A (query, key) pair at dh = 8 is 16
// multiply-adds (q.k and p.v) against one exp, so on the f32 FMA pipe the
// products bound it at twice the exps' time.  The design:
//   * Products on the tensor cores as 3xTF32 (mma.m16n8k8): each operand
//     split into hi = tf32(x) (rounded to nearest) and lo = x - hi (read
//     truncated to TF32), c += lo.hi + hi.lo + hi.hi in f32, about 2^-20
//     relative, so K4's f32 bounds still hold (one TF32 pass rounds at
//     2^-11 and does not).  Tripled, the products (3 x 4 flops a pair and
//     head dim over 495 TFLOP/s) still take less than the exps (one a pair
//     on the SFU, about 4.2 T/s).  The split is integer and f32 arithmetic:
//     with cvt.rna.tf32 (two a split; K, V and P make 128 a warp's 64-key
//     tile) the P.V stage took twice as long (probes/k4_stages.py), the
//     cvts sharing the exps' 16-a-clock unit.  A warp owns 16 query rows
//     of one (sample, head): S = Q.K^T is one mma (x3) for 8 keys (k = dh
//     = 8; dh 16 is two k-steps, dh 4 pads with zeros), O += P.V one mma
//     (x3) for 8 keys, the groups of 8 keys adding to four accumulators in
//     turn (one accumulator chained every mma of a tile).  The score
//     accumulator holds keys 2t, 2t+1 of rows g, g+8, and P.V's A fragment
//     wants k-columns t, t+4: the 8 keys are relabelled (k-column t is key
//     2t, t+4 is key 2t+1) and V's B fragment is read from key rows 2t and
//     2t+1, so no shuffle moves P.
//   * The softmax a 64-key tile at a time (FlashAttention-2): q carries
//     scale*log2(e), so p = 2^(s - m) on the SFU; the row max and the
//     rescale of O once a tile, with no branch per key; the row sums stay
//     per thread until the end.
//   * Only valid keys: a block compacts its sample's mask (ballot, popc,
//     warp counts in shared memory) into a list of up to kWindow key
//     offsets, and stages only those rows, so work scales with the valid
//     count (expt 2's rank masks keep K of 1025).  Masked keys add nothing
//     in the JAX kernel either.  A row with no valid key gets zeros and
//     lse = +inf.
//   * cp.async copies the gathered 16-byte pieces of each head row into a
//     ring of kRing stages, one barrier a tile, so three tiles land while
//     one is computed; slots past the valid count are zero-filled.  The
//     rows are gathered and 256 bytes apart (H*dh floats), not a box, so
//     TMA is not used.  Staged rows are dh + 4 floats apart, which makes
//     both fragments' shared-memory reads free of bank conflicts.
//   * Geometry (planned by the wrapper, ops/kernels/mha.py::fwd_plan): a
//     block of 4 warps holds 64 query rows of one (sample, head).  Fewer
//     than 33 queries (PMA: 1; N = 17-32) leave warps without rows, so
//     there the warps split each key tile instead (parts = 2 or 4) and
//     merge their (m, l, O) in shared memory.  Where the blocks would not
//     fill the card twice (3ST training's MAB0 and PMA at B = 16: 128
//     blocks), each row's keys are split over `splits` blocks, whose
//     partial (m, l, O) `mha_fwd_merge_kernel` merges.  At most 64 keys
//     and dh <= 8 (MAB1's keys are the 64 inducing summaries: half of an
//     FST step's scores, two thirds at expt 2's K 501) take
//     `mha_fwd_short_kernel`: the keys' split fragments are made once a
//     block, and each warp streams its query tiles through a cp.async
//     ring of its own, with no block barrier after the start.
// The forward writes `out` and the row log-sum-exp `lse` [B, H, N] of the
// scaled logits in natural log (+inf for a row with no valid key), which
// the backward reads.
//
// Backward (two kernels, FlashAttention-2 style, no atomics, so gradients
// are deterministic):
//   dq    one block per (sample, head, query tile); recomputes p = exp(s -
//         lse), writes dq and the row term D = g . out [B, H, N] that the
//         dk/dv kernel reads;
//   dkdv  one block per (sample, head, key tile), looping over query tiles:
//         dv_j = sum_i p g_i, dk_j = sum_i p (g_i . v_j - D_i) q_i scale.
// Each (query, head) pair goes to one thread (f32 FMAs) with the staged key
// and value rows read as shared-memory broadcasts; a block of kThreads
// threads holds `qt` queries and splits each query's keys over kThreads /
// qt threads, merged in shared memory at the end (the dk/dv kernel splits
// each key's queries the same way).  Keys are tiled (kTile rows of K and V
// in shared memory) instead of held whole as the TPU kernel holds them in
// VMEM.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

// the backward kernels' blocks
constexpr int kThreads = 256;
constexpr int kTile = 256;   // key (dq) or query (dkdv) rows per stage

template <int DH>
__device__ __forceinline__ float dot(const float (&a)[DH], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(a[d], x.x, s);
    s = fmaf(a[d + 1], x.y, s);
    s = fmaf(a[d + 2], x.z, s);
    s = fmaf(a[d + 3], x.w, s);
  }
  return s;
}

template <int DH>
__device__ __forceinline__ void axpy(float (&acc)[DH], float p, const float* x) {
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(x + d);
    acc[d] = fmaf(p, v.x, acc[d]);
    acc[d + 1] = fmaf(p, v.y, acc[d + 1]);
    acc[d + 2] = fmaf(p, v.z, acc[d + 2]);
    acc[d + 3] = fmaf(p, v.w, acc[d + 3]);
  }
}

// A head row of DH floats moves as DH/4 16-byte vectors: rows start
// 16-byte aligned (the wrapper passes aligned bases; H*DH and DH are
// multiples of 4), and one thread's row is then whole sectors, not DH
// scalar requests 4*H*DH bytes apart.
template <int DH>
__device__ __forceinline__ void load_row(float (&r)[DH], const float* __restrict__ p,
                                         float mul) {
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p + d));
    r[d] = x.x * mul;
    r[d + 1] = x.y * mul;
    r[d + 2] = x.z * mul;
    r[d + 3] = x.w * mul;
  }
}

template <int DH>
__device__ __forceinline__ void store_row(float* __restrict__ p, const float (&r)[DH],
                                          float mul) {
#pragma unroll
  for (int d = 0; d < DH; d += 4)
    *reinterpret_cast<float4*>(p + d) =
        make_float4(r[d] * mul, r[d + 1] * mul, r[d + 2] * mul, r[d + 3] * mul);
}

// Stage rows [r0, r0 + n) of head h of sample b from `src` [B, R, H*DH]
// into `dst` [n, DH] (and of `src2` into `dst2` when given), 16 bytes at a
// time.
template <int DH>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      const float* __restrict__ src2,
                                      float* dst, float* dst2, int b, int R,
                                      int H, int h, int r0, int n, float mul) {
  constexpr int kVec = DH / 4;  // float4s per head row
  const int dv = H * DH;
  for (int e = threadIdx.x; e < n * kVec; e += kThreads) {
    const size_t g = ((size_t)b * R + r0 + e / kVec) * dv + h * DH + (e % kVec) * 4;
    float4 x = __ldg(reinterpret_cast<const float4*>(src + g));
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    reinterpret_cast<float4*>(dst)[e] = x;
    if (src2 != nullptr)
      reinterpret_cast<float4*>(dst2)[e] = __ldg(reinterpret_cast<const float4*>(src2 + g));
  }
}

// Block -> (sample b, head h, tile t of `per` rows out of R), as the host
// numbers them: blockIdx.x = (b * H + h) * ntiles + t.
struct Place {
  int b, h, row, slot, split, splits;
  bool active;
};

__device__ __forceinline__ Place place(int R, int H, int per) {
  const int ntiles = (R + per - 1) / per;
  Place p;
  const int t = blockIdx.x % ntiles, bh = blockIdx.x / ntiles;
  p.h = bh % H;
  p.b = bh / H;
  p.slot = threadIdx.x % per;
  p.split = threadIdx.x / per;
  p.splits = kThreads / per;
  p.row = t * per + p.slot;
  p.active = p.row < R;
  return p;
}

__device__ __forceinline__ float key_ok(const unsigned char* mask, int b, int M, int j) {
  return (mask == nullptr || mask[(size_t)b * M + j]) ? 1.f : 0.f;
}

// ---- forward ---------------------------------------------------------------

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kKeyTile = 64;    // keys a ring stage holds
constexpr int kQRing = 4;       // 16-row query tiles a warp of the short kernel has in flight
constexpr int kWindow = 8192;   // keys a block compacts at a time (16-bit offsets)
// Stage probe (probes/k4_stages.py builds copies with this edited): 1 stops
// after the key compaction (the short kernel: after loading K and V), 2
// after the staging of the keys (the short kernel: of the queries), 3
// after Q.K^T and the softmax (P.V left out); 0 runs the whole.
constexpr int kStopAfter = 0;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH>
struct FwdShape {
  static constexpr int kSteps = DH < 8 ? 1 : DH / 8;  // k-steps of Q.K^T, n-tiles of P.V
  static constexpr int kStride = DH + 4;              // floats a staged row
  static constexpr int kStage = 2 * kKeyTile * kStride;  // K rows, then V rows
  // ring stages: three tiles in flight while one is computed (two at dh
  // 16, whose ring must leave room for the key list in 48 KB)
  static constexpr int kRing = DH < 16 ? 4 : 3;
  // O accumulators that P.V's groups of 8 keys take in turn: each group's
  // three mmas depend on each other, and one accumulator for all groups
  // would chain every mma of a tile
  static constexpr int kAcc = 4 / kSteps;
};

// Offsets (within the window of `n` keys at `m`) of the valid keys, in key
// order by warp quarter, into `list`; returns their count.  All threads.
__device__ __forceinline__ int compact_keys(const unsigned char* __restrict__ m, int n,
                                            uint16_t* list, int* counts) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (n + kFwdThreads - 1) / kFwdThreads * 32;  // keys a warp, multiple of 32
  const int lo = warp * per, hi = min(n, lo + per);
  int cnt = 0;
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    cnt += __popc(__ballot_sync(pcaudio::kFullMask, j < hi && m[j] != 0));
  }
  if (lane == 0) counts[warp] = cnt;
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kFwdWarps; ++w) {
    base += w < warp ? counts[w] : 0;
    total += counts[w];
  }
  const unsigned below = (1u << lane) - 1u;
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    const bool ok = j < hi && m[j] != 0;
    const unsigned bal = __ballot_sync(pcaudio::kFullMask, ok);
    if (ok) list[base + __popc(bal & below)] = (uint16_t)j;
    base += __popc(bal);
  }
  __syncthreads();
  return total;
}

// Copy key slots [first, first + kKeyTile) of the window (slot i is key
// offset list[i], or i with no mask) of head h into a ring stage: K rows,
// then V rows, kStride floats apart; slots at or past `n` are zero-filled.
template <int DH>
__device__ __forceinline__ void stage_keys(float* dst, const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const uint16_t* list, bool listed,
                                           size_t key0, int H, int h, int first, int n) {
  constexpr int kVec = DH / 4;  // 16-byte pieces a head row
  constexpr int kStride = FwdShape<DH>::kStride;
#pragma unroll
  for (int rep = 0; rep < kVec; ++rep) {  // 2 * kKeyTile * kVec pieces, kVec a thread
    const int c = threadIdx.x + rep * kFwdThreads;
    const int arr = c / (kKeyTile * kVec);
    const int rem = c - arr * kKeyTile * kVec;
    const int i = rem / kVec, piece = rem % kVec;
    const int slot = first + i;
    const float* src = k;
    int bytes = 0;
    if (slot < n) {
      const int j = listed ? list[slot] : slot;
      src = (arr ? v : k) + ((key0 + j) * H + h) * DH + piece * 4;
      bytes = 16;
    }
    pcaudio::cp_async16_zfill(dst + (arr * kKeyTile + i) * kStride + piece * 4, src, bytes);
  }
}

// One staged tile of `nk` keys against this warp's 16 query rows: the
// warp's groups of 8 keys are (part * G + gi), gi < G.  Updates the running
// row maxima m (log2 units, quad-uniform), the per-thread row sums l and
// the O accumulators (group gi adds to o[gi % kAcc]).
template <int DH, int G>
__device__ __forceinline__ void attend_tile(
    const float* ks, int nk, int part, int g, int t,
    const uint32_t (&qh)[FwdShape<DH>::kSteps][4],
    const uint32_t (&ql)[FwdShape<DH>::kSteps][4],
    float (&o)[FwdShape<DH>::kAcc][FwdShape<DH>::kSteps][4], float (&m)[2], float (&l)[2]) {
  constexpr int KS = FwdShape<DH>::kSteps, STR = FwdShape<DH>::kStride;
  constexpr int NA = FwdShape<DH>::kAcc;
  const float* vs = ks + kKeyTile * STR;
  float s[G][4];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int key = (part * G + gi) * 8 + g;  // B column g: key g of the group
#pragma unroll
    for (int r = 0; r < 4; ++r) s[gi][r] = 0.f;
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      uint32_t h0, l0, h1 = 0, l1 = 0;
      pcaudio::split_tf32(ks[key * STR + st * 8 + t], h0, l0);
      if (DH >= 8) pcaudio::split_tf32(ks[key * STR + st * 8 + t + 4], h1, l1);
      pcaudio::mma_3xtf32_k8(s[gi], qh[st], ql[st], h0, h1, l0, l1);
    }
    if (nk < kKeyTile) {  // the window's last tile: slots past nk hold no key
      const int c = (part * G + gi) * 8 + 2 * t;
      if (c >= nk) s[gi][0] = s[gi][2] = -INFINITY;
      if (c + 1 >= nk) s[gi][1] = s[gi][3] = -INFINITY;
    }
  }
  // rows g (regs 0, 1) and g + 8 (regs 2, 3): the tile's maxima over the quad
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    mx[0] = fmaxf(mx[0], fmaxf(s[gi][0], s[gi][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[gi][2], s[gi][3]));
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(pcaudio::kFullMask, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(pcaudio::kFullMask, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    base[r] = mn == -INFINITY ? 0.f : mn;  // no key yet: keep 2^(-inf) = 0
    const float alpha = pcaudio::ex2(m[r] - base[r]);
    m[r] = mn;
    l[r] *= alpha;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int st = 0; st < KS; ++st) {
        o[a][st][2 * r] *= alpha;
        o[a][st][2 * r + 1] *= alpha;
      }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      s[gi][r] = pcaudio::ex2(s[gi][r] - base[r >> 1]);
      l[r >> 1] += s[gi][r];
    }
  if (kStopAfter == 3) return;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    // P as an A fragment in the relabelled key order: k-column t is key
    // 2t (C regs 0, 2), k-column t + 4 is key 2t + 1 (C regs 1, 3)
    uint32_t ph[4], pl[4];
    pcaudio::split_tf32(s[gi][0], ph[0], pl[0]);
    pcaudio::split_tf32(s[gi][2], ph[1], pl[1]);
    pcaudio::split_tf32(s[gi][1], ph[2], pl[2]);
    pcaudio::split_tf32(s[gi][3], ph[3], pl[3]);
    const int key = (part * G + gi) * 8 + 2 * t;  // B rows t, t + 4: keys 2t, 2t + 1
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      const int d = st * 8 + g;  // B column g: head dim d
      uint32_t h0 = 0, l0 = 0, h1 = 0, l1 = 0;
      if (d < DH) {
        pcaudio::split_tf32(vs[key * STR + d], h0, l0);
        pcaudio::split_tf32(vs[(key + 1) * STR + d], h1, l1);
      }
      pcaudio::mma_3xtf32_k8(o[gi % NA][st], ph, pl, h0, h1, l0, l1);
    }
  }
}

// blockIdx.x = ((b * H + h) * qtiles + qt) * splits + sp.  Warp w holds
// query rows qt * 16 * WQ + (w % WQ) * 16 + [0, 16) and key part w / WQ of
// the keys [M * sp / splits, M * (sp + 1) / splits).  With splits == 1 it
// writes out and lse; otherwise the partial (m in log2 units, l, O
// unnormalised) of its key range into part_m / part_l [splits, B, H, N]
// and part_o [splits, B, N, H*DH].
template <int DH, int P>
__global__ void __launch_bounds__(kFwdThreads)
mha_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const unsigned char* __restrict__ mask,
               float* __restrict__ out, float* __restrict__ lse,
               float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_o, int B, int N, int M, int H, int qtiles,
               int splits, float qscale) {
  using S = FwdShape<DH>;
  constexpr int WQ = kFwdWarps / P;  // query tiles of 16 rows a block
  constexpr int G = 8 / P;           // groups of 8 keys a warp takes of each tile
  constexpr int KS = S::kSteps;
  __shared__ __align__(16) float ring[S::kRing * S::kStage];
  __shared__ uint16_t list[kWindow];
  __shared__ int counts[kFwdWarps];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq = warp % WQ, part = warp / WQ;
  int x = blockIdx.x;
  const int sp = x % splits;
  x /= splits;
  const int qt = x % qtiles;
  x /= qtiles;
  const int h = x % H, b = x / H;
  const int row0 = (qt * WQ + wq) * 16;
  const int dv = H * DH;

  // the warp's query rows as A fragments, times scale*log2(e), split
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int st = 0; st < KS; ++st)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + ((r & 1) << 3), d = st * 8 + t + ((r & 2) << 1);
      const float xq = row < N && d < DH
                           ? __ldg(q + ((size_t)b * N + row) * dv + h * DH + d) * qscale
                           : 0.f;
      pcaudio::split_tf32(xq, qh[st][r], ql[st][r]);
    }

  float oa[S::kAcc][KS][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int a = 0; a < S::kAcc; ++a)
#pragma unroll
    for (int st = 0; st < KS; ++st)
#pragma unroll
      for (int r = 0; r < 4; ++r) oa[a][st][r] = 0.f;

  const int kb = (int)((long long)M * sp / splits);
  const int ke = (int)((long long)M * (sp + 1) / splits);
  for (int w0 = kb; w0 < ke; w0 += kWindow) {
    const int wn = min(kWindow, ke - w0);
    const size_t key0 = (size_t)b * M + w0;
    const bool listed = mask != nullptr;
    const int n = listed ? compact_keys(mask + key0, wn, list, counts) : wn;
    const int ntiles = kStopAfter == 1 ? 0 : (n + kKeyTile - 1) / kKeyTile;
    if (kStopAfter == 1 && threadIdx.x == 0) l[0] += (float)n;  // keeps the compaction
#pragma unroll
    for (int st = 0; st < S::kRing - 1; ++st) {
      if (st < ntiles)
        stage_keys<DH>(ring + st * S::kStage, k, v, list, listed, key0, H, h,
                       st * kKeyTile, n);
      pcaudio::cp_async_commit();
    }
    for (int it = 0; it < ntiles; ++it) {
      pcaudio::cp_async_wait<S::kRing - 2>();  // this thread's copies of tile it
      __syncthreads();  // everyone's; and every warp is done with tile it - 1
      const int next = it + S::kRing - 1;     // into tile it - 1's stage
      if (next < ntiles)
        stage_keys<DH>(ring + next % S::kRing * S::kStage, k, v, list, listed, key0, H, h,
                       next * kKeyTile, n);
      pcaudio::cp_async_commit();
      if (kStopAfter == 0 || kStopAfter > 2)
        attend_tile<DH, G>(ring + it % S::kRing * S::kStage,
                           min(kKeyTile, n - it * kKeyTile), part, g, t, qh, ql, oa, m, l);
    }
    __syncthreads();  // the ring and the list are free again
  }
  float o[KS][4];
#pragma unroll
  for (int st = 0; st < KS; ++st)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      o[st][r] = oa[0][st][r];
#pragma unroll
      for (int a = 1; a < S::kAcc; ++a) o[st][r] += oa[a][st][r];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(pcaudio::kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(pcaudio::kFullMask, l[r], 2);
  }

  if constexpr (P > 1) {  // merge the key parts of each query tile
    constexpr int W = DH + 2;
    float* red = ring;  // kFwdWarps * 16 rows of (m, l, O): free after the last tile
    float* mine = red + warp * 16 * W;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* e = mine + (g + 8 * r) * W;
      if (t == 0) {
        e[0] = m[r];
        e[1] = l[r];
      }
#pragma unroll
      for (int st = 0; st < KS; ++st)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (st * 8 + 2 * t + c < DH) e[2 + st * 8 + 2 * t + c] = o[st][2 * r + c];
    }
    __syncthreads();
    if (part != 0) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int p = 0; p < P; ++p) mx = fmaxf(mx, red[((p * WQ + wq) * 16 + g + 8 * r) * W]);
      const float base = mx == -INFINITY ? 0.f : mx;
      float L = 0.f, acc[KS][2] = {};
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* e = red + ((p * WQ + wq) * 16 + g + 8 * r) * W;
        const float c = pcaudio::ex2(e[0] - base);
        L = fmaf(e[1], c, L);
#pragma unroll
        for (int st = 0; st < KS; ++st)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
            if (st * 8 + 2 * t + cc < DH)
              acc[st][cc] = fmaf(e[2 + st * 8 + 2 * t + cc], c, acc[st][cc]);
      }
      m[r] = mx;
      l[r] = L;
#pragma unroll
      for (int st = 0; st < KS; ++st) {
        o[st][2 * r] = acc[st][0];
        o[st][2 * r + 1] = acc[st][1];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= N) continue;
    if (splits == 1) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      float* dst = out + ((size_t)b * N + row) * dv + h * DH;
#pragma unroll
      for (int st = 0; st < KS; ++st)
        if (st * 8 + 2 * t < DH)
          *reinterpret_cast<float2*>(dst + st * 8 + 2 * t) =
              make_float2(o[st][2 * r] * inv, o[st][2 * r + 1] * inv);
      if (t == 0)
        lse[((size_t)b * H + h) * N + row] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : INFINITY;
    } else {
      const size_t hrow = (((size_t)sp * B + b) * H + h) * N + row;
      if (t == 0) {
        part_m[hrow] = m[r];
        part_l[hrow] = l[r];
      }
      float* dst = part_o + (((size_t)sp * B + b) * N + row) * dv + h * DH;
#pragma unroll
      for (int st = 0; st < KS; ++st)
        if (st * 8 + 2 * t < DH)
          *reinterpret_cast<float2*>(dst + st * 8 + 2 * t) =
              make_float2(o[st][2 * r], o[st][2 * r + 1]);
    }
  }
}

// At most kKeyTile keys (MAB1's keys are the 64 inducing summaries): warp 0
// splits all of them once into the B fragments every lane needs (K for
// Q.K^T: group gi's column g is key 8 gi + g; V for P.V: rows t, t + 4 are
// keys 8 gi + 2t, 8 gi + 2t + 1), stored lane by lane in shared memory, and
// each warp walks the block's 16-row query tiles w, w + 4, ... of rows
// [qt * rows, (qt + 1) * rows), reading a group's four fragment words as
// one 16-byte load.  One tile of keys needs no running max.  Held in
// registers the fragments took 144 of them (three blocks an SM); from
// shared memory six blocks fit.  blockIdx.x = (b * H + h) * qtiles + qt.
template <int DH>
__global__ void __launch_bounds__(kFwdThreads, 6)
mha_fwd_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const unsigned char* __restrict__ mask,
                     float* __restrict__ out, float* __restrict__ lse, int N, int M, int H,
                     int qtiles, int rows, float qscale) {
  static_assert(DH <= 8, "head rows of at most 8 floats: one k-step, one n-tile");
  // [group][lane]: (hi of B reg 0, hi of reg 1, lo of reg 0, lo of reg 1)
  __shared__ uint4 kfrag[8][32], vfrag[8][32];
  __shared__ unsigned okbits[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x % qtiles, bh = blockIdx.x / qtiles;
  const int h = bh % H, b = bh / H;
  const int dv = H * DH;
  if (warp == 0) {
    const float* kb = k + (size_t)b * M * dv + h * DH;
    const float* vb = v + (size_t)b * M * dv + h * DH;
    unsigned ok = 0;  // bit 2 gi + c: key 8 gi + 2t + c (this lane's score columns) is valid
#pragma unroll
    for (int gi = 0; gi < 8; ++gi) {
      const int key = gi * 8 + g;
      float k0 = 0.f, k1 = 0.f;
      if (key < M) {
        k0 = __ldg(kb + (size_t)key * dv + t);
        if (DH >= 8) k1 = __ldg(kb + (size_t)key * dv + t + 4);
      }
      uint4 f;
      pcaudio::split_tf32(k0, f.x, f.z);
      pcaudio::split_tf32(k1, f.y, f.w);
      kfrag[gi][lane] = f;
      float x[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = gi * 8 + 2 * t + c;
        const bool valid = j < M && (mask == nullptr || mask[(size_t)b * M + j] != 0);
        ok |= (unsigned)valid << (2 * gi + c);
        x[c] = valid && g < DH ? __ldg(vb + (size_t)j * dv + g) : 0.f;
      }
      pcaudio::split_tf32(x[0], f.x, f.z);
      pcaudio::split_tf32(x[1], f.y, f.w);
      vfrag[gi][lane] = f;
    }
    okbits[lane] = ok;
  }
  __syncthreads();
  const unsigned ok = okbits[lane];
  const bool all_valid = __all_sync(pcaudio::kFullMask, ok == 0xffffu);

  unsigned loaded = 0;  // stage probe's cuts 1, 2: keeps the K and V loads live
  if (kStopAfter == 1 || kStopAfter == 2)
#pragma unroll
    for (int gi = 0; gi < 8; ++gi)
      loaded ^= kfrag[gi][lane].x ^ kfrag[gi][lane].w ^ vfrag[gi][lane].y ^ vfrag[gi][lane].z;

  // this warp's query tiles: rows row0(i) + [0, 16), row0(i) = qt * rows +
  // (warp + 4 i) * 16 below `end`; tile i goes through ring slot i % kQRing:
  // lane L copies 16 bytes of row L / kPieces (zero-filled past N)
  constexpr int kPieces = DH / 4, kStr = DH + 4;
  __shared__ __align__(16) float qring[kFwdWarps][kQRing][16 * kStr];
  const int end = min(N, (qt + 1) * rows);
  const int first = qt * rows + warp * 16, step = kFwdWarps * 16;
  const int ntiles = kStopAfter != 1 && first < end ? (end - first + step - 1) / step : 0;
  if (kStopAfter == 1 && first < N && lane == 0)
    lse[((size_t)b * H + h) * N + first] = __uint_as_float(loaded & 0x007fffffu);
  auto stage_q = [&](int i) {
    if (i < ntiles && lane < 16 * kPieces) {
      const int row = first + i * step + lane / kPieces, piece = lane % kPieces;
      const float* src = row < N ? q + ((size_t)b * N + row) * dv + h * DH + piece * 4 : q;
      pcaudio::cp_async16_zfill(&qring[warp][i % kQRing][(lane / kPieces) * kStr + piece * 4],
                                src, row < N ? 16 : 0);
    }
    pcaudio::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kQRing - 1; ++i) stage_q(i);
  for (int i = 0; i < ntiles; ++i) {
    __syncwarp();  // every lane is done reading tile i - 1's slot
    stage_q(i + kQRing - 1);
    pcaudio::cp_async_wait<kQRing - 1>();
    __syncwarp();
    const int row0 = first + i * step;
    const float* qs = qring[warp][i % kQRing];
    uint32_t qh[4], ql[4];  // (row g, dim t), (g+8, t), (g, t+4), (g+8, t+4)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int d = t + ((r & 2) << 1);
      const float x = d < DH ? qs[(g + ((r & 1) << 3)) * kStr + d] * qscale : 0.f;
      pcaudio::split_tf32(x, qh[r], ql[r]);
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float oa[4][4] = {};  // group gi adds to oa[gi % 4], as in attend_tile
    if (kStopAfter == 2) {
      l[0] = l[1] = 1.f + __uint_as_float((loaded ^ qh[0] ^ ql[3]) & 0x007fffffu);
      m[0] = m[1] = 0.f;
    }
    if (kStopAfter == 0 || kStopAfter > 2) {
      float s[8][4];
#pragma unroll
      for (int gi = 0; gi < 8; ++gi) {
#pragma unroll
        for (int r = 0; r < 4; ++r) s[gi][r] = 0.f;
        const uint4 f = kfrag[gi][lane];
        pcaudio::mma_3xtf32_k8(s[gi], qh, ql, f.x, f.y, f.z, f.w);
        if (!all_valid)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (!((ok >> (2 * gi + c)) & 1u)) s[gi][c] = s[gi][c + 2] = -INFINITY;
      }
#pragma unroll
      for (int gi = 0; gi < 8; ++gi) {
        m[0] = fmaxf(m[0], fmaxf(s[gi][0], s[gi][1]));
        m[1] = fmaxf(m[1], fmaxf(s[gi][2], s[gi][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = fmaxf(m[r], __shfl_xor_sync(pcaudio::kFullMask, m[r], 1));
        m[r] = fmaxf(m[r], __shfl_xor_sync(pcaudio::kFullMask, m[r], 2));
      }
      const float base[2] = {m[0] == -INFINITY ? 0.f : m[0], m[1] == -INFINITY ? 0.f : m[1]};
#pragma unroll
      for (int gi = 0; gi < 8; ++gi) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[gi][r] = pcaudio::ex2(s[gi][r] - base[r >> 1]);
          l[r >> 1] += s[gi][r];
        }
        if (kStopAfter == 3) continue;
        uint32_t ph[4], pl[4];  // the relabelled A fragment, as in attend_tile
        pcaudio::split_tf32(s[gi][0], ph[0], pl[0]);
        pcaudio::split_tf32(s[gi][2], ph[1], pl[1]);
        pcaudio::split_tf32(s[gi][1], ph[2], pl[2]);
        pcaudio::split_tf32(s[gi][3], ph[3], pl[3]);
        const uint4 f = vfrag[gi][lane];
        pcaudio::mma_3xtf32_k8(oa[gi % 4], ph, pl, f.x, f.y, f.z, f.w);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(pcaudio::kFullMask, l[r], 1);
        l[r] += __shfl_xor_sync(pcaudio::kFullMask, l[r], 2);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= N) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      const float o0 = (oa[0][2 * r] + oa[1][2 * r]) + (oa[2][2 * r] + oa[3][2 * r]);
      const float o1 =
          (oa[0][2 * r + 1] + oa[1][2 * r + 1]) + (oa[2][2 * r + 1] + oa[3][2 * r + 1]);
      if (2 * t < DH)
        *reinterpret_cast<float2*>(out + ((size_t)b * N + row) * dv + h * DH + 2 * t) =
            make_float2(o0 * inv, o1 * inv);
      if (t == 0)
        lse[((size_t)b * H + h) * N + row] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : INFINITY;
    }
  }
}

// The key splits' partials of row (b, h, i), one thread a row: out and lse.
template <int DH>
__global__ void __launch_bounds__(256)
mha_fwd_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                     const float* __restrict__ part_o, float* __restrict__ out,
                     float* __restrict__ lse, int B, int N, int H, int splits) {
  const size_t rows = (size_t)B * H * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;  // (b * H + h) * N + row
  if (i >= rows) return;
  const int row = (int)(i % N), h = (int)(i / N % H), b = (int)(i / N / H);
  const int dv = H * DH;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_m[s * rows + i]);
  const float base = mx == -INFINITY ? 0.f : mx;
  float L = 0.f, acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float c = exp2f(part_m[s * rows + i] - base);  // 0 for a split with no key
    L = fmaf(part_l[s * rows + i], c, L);
    const float* o = part_o + (((size_t)s * B + b) * N + row) * dv + h * DH;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(o + d);
      acc[d] = fmaf(x.x, c, acc[d]);
      acc[d + 1] = fmaf(x.y, c, acc[d + 1]);
      acc[d + 2] = fmaf(x.z, c, acc[d + 2]);
      acc[d + 3] = fmaf(x.w, c, acc[d + 3]);
    }
  }
  store_row<DH>(out + ((size_t)b * N + row) * dv + h * DH, acc, L > 0.f ? 1.f / L : 0.f);
  lse[i] = L > 0.f ? (mx + log2f(L)) * kLn2 : INFINITY;
}

// ---- backward --------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(kThreads)
mha_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const unsigned char* __restrict__ mask,
              const float* __restrict__ out, const float* __restrict__ lse,
              const float* __restrict__ g, float* __restrict__ delta,
              float* __restrict__ dq, int N, int M, int H, int qt, float scale) {
  __shared__ __align__(16) float sm[kTile * (2 * DH + 1)];
  float* ks = sm;
  float* vs = ks + kTile * DH;
  float* mk = vs + kTile * DH;
  const Place p = place(N, H, qt);
  const int dv = H * DH;
  const size_t qrow = ((size_t)p.b * N + p.row) * dv + p.h * DH;
  const size_t hrow = ((size_t)p.b * H + p.h) * N + p.row;

  float qs[DH], gs[DH], acc[DH];
  float D = 0.f, lrow = INFINITY;
  if (p.active) {
    float os[DH];
    load_row<DH>(qs, q + qrow, scale);
    load_row<DH>(gs, g + qrow, 1.f);
    load_row<DH>(os, out + qrow, 1.f);
#pragma unroll
    for (int d = 0; d < DH; ++d) D = fmaf(gs[d], os[d], D);
    lrow = lse[hrow];
    if (p.split == 0) delta[hrow] = D;
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  for (int j0 = 0; j0 < M; j0 += kTile) {
    const int nk = min(kTile, M - j0);
    __syncthreads();
    stage<DH>(k, v, ks, vs, p.b, M, H, p.h, j0, nk, 1.f);
    for (int r = threadIdx.x; r < nk; r += kThreads) mk[r] = key_ok(mask, p.b, M, j0 + r);
    __syncthreads();
    if (!p.active) continue;
    for (int j = p.split; j < nk; j += p.splits) {
      if (mk[j] == 0.f) continue;
      const float e = __expf(dot<DH>(qs, ks + j * DH) - lrow);
      const float ds = e * (dot<DH>(gs, vs + j * DH) - D);
      axpy<DH>(acc, ds, ks + j * DH);
    }
  }

  __syncthreads();
  float* red = sm;
#pragma unroll
  for (int d = 0; d < DH; ++d) red[threadIdx.x * DH + d] = acc[d];
  __syncthreads();
  if (!p.active || p.split != 0) return;
  float sum[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) sum[d] = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float* o = red + (s * qt + p.slot) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) sum[d] += o[d];
  }
  store_row<DH>(dq + qrow, sum, scale);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
mha_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const unsigned char* __restrict__ mask,
                const float* __restrict__ lse, const float* __restrict__ g,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dvo, int N, int M, int H, int kt, float scale) {
  __shared__ __align__(16) float sm[kTile * (2 * DH + 2)];
  float* qsm = sm;                 // scaled queries
  float* gsm = qsm + kTile * DH;
  float* lsm = gsm + kTile * DH;
  float* dsm = lsm + kTile;
  const Place p = place(M, H, kt);
  const int dv = H * DH;
  const size_t krow = ((size_t)p.b * M + p.row) * dv + p.h * DH;
  const bool live = p.active && key_ok(mask, p.b, M, p.row) != 0.f;

  float kj[DH], vj[DH], dka[DH], dva[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) kj[d] = vj[d] = dka[d] = dva[d] = 0.f;
  if (live) {
    load_row<DH>(kj, k + krow, 1.f);
    load_row<DH>(vj, v + krow, 1.f);
  }
  const size_t hbase = ((size_t)p.b * H + p.h) * N;
  for (int i0 = 0; i0 < N; i0 += kTile) {
    const int ni = min(kTile, N - i0);
    __syncthreads();
    stage<DH>(q, nullptr, qsm, nullptr, p.b, N, H, p.h, i0, ni, scale);
    stage<DH>(g, nullptr, gsm, nullptr, p.b, N, H, p.h, i0, ni, 1.f);
    for (int r = threadIdx.x; r < ni; r += kThreads) {
      lsm[r] = lse[hbase + i0 + r];
      dsm[r] = delta[hbase + i0 + r];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = p.split; i < ni; i += p.splits) {
      const float* qi = qsm + i * DH;
      const float* gi = gsm + i * DH;
      const float e = __expf(dot<DH>(kj, qi) - lsm[i]);
      const float ds = e * (dot<DH>(vj, gi) - dsm[i]);
      axpy<DH>(dva, e, gi);
      axpy<DH>(dka, ds, qi);
    }
  }

  __syncthreads();
  float* red = sm;  // kThreads * 2 * DH floats
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    red[threadIdx.x * 2 * DH + d] = dka[d];
    red[threadIdx.x * 2 * DH + DH + d] = dva[d];
  }
  __syncthreads();
  if (!p.active || p.split != 0) return;
  float sk[DH], sv[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) sk[d] = sv[d] = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float* o = red + (s * kt + p.slot) * 2 * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      sk[d] += o[d];
      sv[d] += o[DH + d];
    }
  }
  store_row<DH>(dk + krow, sk, 1.f);
  store_row<DH>(dvo + krow, sv, 1.f);
}

// Rows per block: the smallest power of two >= R, at most kThreads.
int rows_per_block(int R) {
  int per = 1;
  while (per < R && per < kThreads) per <<= 1;
  return per;
}

int grid_of(int B, int H, int R, int per, unsigned* blocks) {
  const long long n = (long long)B * H * ((R + per - 1) / per);
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)n;
  return 0;
}

template <int DH, int P>
int fwd(const float* q, const float* k, const float* v, const unsigned char* mask,
        float* out, float* lse, float* part_m, float* part_l, float* part_o, int B,
        int N, int M, int H, int rows, int splits, float scale, cudaStream_t st) {
  const int qtiles = (N + rows - 1) / rows;
  const long long n = (long long)B * H * qtiles * splits;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if constexpr (P == 0) {
    if (M > kKeyTile || splits != 1 || rows % 16) return (int)cudaErrorInvalidValue;
    mha_fwd_short_kernel<DH><<<(unsigned)n, kFwdThreads, 0, st>>>(
        q, k, v, mask, out, lse, N, M, H, qtiles, rows, scale * kLog2e);
    return (int)cudaGetLastError();
  } else {
    if (rows != 16 * kFwdWarps / P) return (int)cudaErrorInvalidValue;
    mha_fwd_kernel<DH, P><<<(unsigned)n, kFwdThreads, 0, st>>>(
        q, k, v, mask, out, lse, part_m, part_l, part_o, B, N, M, H, qtiles, splits,
        scale * kLog2e);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || splits == 1) return (int)e;
    const long long rows_all = (long long)B * H * N;
    mha_fwd_merge_kernel<DH><<<(unsigned)((rows_all + 255) / 256), 256, 0, st>>>(
        part_m, part_l, part_o, out, lse, B, N, H, splits);
    return (int)cudaGetLastError();
  }
}

template <int DH>
int bwd(const float* q, const float* k, const float* v, const unsigned char* mask,
        const float* out, const float* lse, const float* g, float* delta, float* dq,
        float* dk, float* dvo, int B, int N, int M, int H, float scale,
        cudaStream_t st) {
  const int qt = rows_per_block(N), kt = rows_per_block(M);
  unsigned qblocks, kblocks;
  if (const int e = grid_of(B, H, N, qt, &qblocks)) return e;
  if (const int e = grid_of(B, H, M, kt, &kblocks)) return e;
  // dq first: it writes the row terms D that dkdv reads (same stream)
  mha_dq_kernel<DH><<<qblocks, kThreads, 0, st>>>(q, k, v, mask, out, lse, g, delta,
                                                  dq, N, M, H, qt, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mha_dkdv_kernel<DH><<<kblocks, kThreads, 0, st>>>(q, k, v, mask, lse, g, delta, dk,
                                                    dvo, N, M, H, kt, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, N, H*dh], k / v [B, M, H*dh] f32 contiguous, 16-byte aligned;
// mask [B, M] bytes or null (all keys valid).  out [B, N, H*dh], lse [B, H,
// N].  A block holds `rows` query rows of one (sample, head).  `parts` 1, 2
// or 4: the tiled kernel, whose blocks hold 64 / parts rows, `parts` warps
// splitting each key tile, and `splits` blocks splitting each row's keys
// (with splits > 1, part_m / part_l [splits, B, H, N] and part_o [splits,
// B, N, H*dh] hold the partials; else they are unused and may be null).
// `parts` 0: the kernel for at most 64 keys and dh <= 8 (splits 1).
extern "C" int pcaudio_mha_fwd(const void* q, const void* k, const void* v,
                               const void* mask, void* out, void* lse, void* part_m,
                               void* part_l, void* part_o, int B, int N, int M, int H,
                               int dh, int parts, int rows, int splits, float scale,
                               void* stream) {
  if (B < 1 || N < 1 || M < 1 || H < 1 || rows < 16 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part_m == nullptr || part_l == nullptr || part_o == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto m = (const unsigned char*)mask;
  const auto st = (cudaStream_t)stream;
#define PCAUDIO_MHA_FWD(DH, P)                                                    \
  if (dh == DH && parts == P)                                                     \
  return fwd<DH, P>((const float*)q, (const float*)k, (const float*)v, m,          \
                    (float*)out, (float*)lse, (float*)part_m, (float*)part_l,      \
                    (float*)part_o, B, N, M, H, rows, splits, scale, st)
  PCAUDIO_MHA_FWD(4, 0);
  PCAUDIO_MHA_FWD(4, 1);
  PCAUDIO_MHA_FWD(4, 2);
  PCAUDIO_MHA_FWD(4, 4);
  PCAUDIO_MHA_FWD(8, 0);
  PCAUDIO_MHA_FWD(8, 1);
  PCAUDIO_MHA_FWD(8, 2);
  PCAUDIO_MHA_FWD(8, 4);
  PCAUDIO_MHA_FWD(16, 1);
  PCAUDIO_MHA_FWD(16, 2);
  PCAUDIO_MHA_FWD(16, 4);
#undef PCAUDIO_MHA_FWD
  return (int)cudaErrorInvalidValue;
}

// The forward's inputs and results plus g = dL/dout; delta [B, H, N] is
// scratch.  Writes dq [B, N, H*dh], dk / dv [B, M, H*dh].
extern "C" int pcaudio_mha_bwd(const void* q, const void* k, const void* v,
                               const void* mask, const void* out, const void* lse,
                               const void* g, void* delta, void* dq, void* dk,
                               void* dv, int B, int N, int M, int H, int dh,
                               float scale, void* stream) {
  if (B < 1 || N < 1 || M < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const auto m = (const unsigned char*)mask;
  const auto st = (cudaStream_t)stream;
#define PCAUDIO_MHA_BWD(DH)                                                    \
  return bwd<DH>((const float*)q, (const float*)k, (const float*)v, m,           \
                 (const float*)out, (const float*)lse, (const float*)g,          \
                 (float*)delta, (float*)dq, (float*)dk, (float*)dv, B, N, M, H,  \
                 scale, st)
  if (dh == 4) PCAUDIO_MHA_BWD(4);
  if (dh == 8) PCAUDIO_MHA_BWD(8);
  if (dh == 16) PCAUDIO_MHA_BWD(16);
#undef PCAUDIO_MHA_BWD
  return (int)cudaErrorInvalidValue;
}
