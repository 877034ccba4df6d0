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
// Backward (redesigned for Hopper: `mha_bwd_fewq_kernel`,
// `mha_bwd_fewk_kernel`, `mha_bwd_merge_kernel`; no atomics, every sum in a
// fixed order, so gradients are deterministic).  Per head, with the
// forward's lse: P = exp(S - lse), dS = P (G V^T - D) with D = rowsum(G
// out), dQ = dS K scale, dK = dS^T Q scale, dV = P^T G.  Five products a
// (query, key) pair against one exp, and each of q, k, v, out, g read and
// dq, dk, dv written once: the bytes bound it (one FST step's attends move
// about 0.71 GB, 0.21 ms), the 3xTF32 products next (0.13 ms).  The design:
//   * The products on the tensor cores as 3xTF32 mma.m16n8k8, as in the
//     forward; P = 2^(S scale log2(e) - lse log2(e)) on the SFU.
//   * One pass over each (query, key) pair, each exp once (the SIMT pair
//     below recomputes every exp in both its kernels).  In every attend the
//     recipes run, one side has at most 64 rows (MAB0: 64 inducing
//     queries, PMA: 1; MAB1: 64 inducing keys).  A block of 4 warps owns
//     one (sample, head) and holds that small side whole as split
//     fragments in shared memory; each warp streams 16-row tiles of the
//     large side through its own cp.async ring.
//   * Keys are always the mma's 16 rows, queries its 8 columns: S^T = K
//     Q^T, dP^T = V G^T, then dV += P^T G and dK += dS^T Q take the
//     score accumulators as A fragments with no data moved (the relabelled
//     k order of the forward's P.V), and PMA's one query wastes 7 of 8
//     columns, not 15 of 16 rows.  dQ = dS K contracts over the keys, the
//     rows: dS^T's 8x8 blocks are transposed in registers (movmatrix on
//     the words' low and high halves), then split.
//   * Few queries (N <= 64, `mha_bwd_fewq_kernel`): a key tile's dK and dV
//     are complete after its pass over the held queries and are written
//     once; dQ accumulates in registers, then over the warps.  Only valid
//     keys are staged (the forward's compact_keys), so work scales with
//     the valid count; masked keys get zero rows.  D and lse log2(e) of
//     the held queries are computed once a block.
//   * Few keys (M <= 64, `mha_bwd_fewk_kernel`): a query tile's dQ is
//     complete and written once; dK and dV accumulate in registers, then
//     over the warps.  D is computed per query tile from its staged G and
//     out rows.
//   * Where B*H blocks would not fill the card twice (3ST training at B =
//     16: 128 blocks), `splits` blocks split the large side; each writes
//     the small side's partial gradient and `mha_bwd_merge_kernel` sums
//     them in split order.  The wrapper plans it
//     (ops/kernels/mha.py::bwd_plan).
// Where both sides exceed 64 rows (no ported model's attend) the backward
// takes the SIMT pair, f32 FMAs with no atomics: `mha_dq_kernel`, one block
// per (sample, head, query tile), recomputes p = exp(s - lse), writes dq
// and D [B, H, N]; `mha_dkdv_kernel`, one block per (sample, head, key
// tile), loops over query tiles for dv_j = sum_i p g_i, dk_j = sum_i p
// (g_i . v_j - D_i) q_i scale; one thread a (query, head) pair or a (key,
// head) pair, the other side staged kTile rows at a time.

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

// ---- backward, one pass a pair (few queries or few keys) --------------------

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRing = 3;               // 16-row tiles a warp has in flight
constexpr int kHeld = 64;                 // rows of the small side a block holds
constexpr int kHeldTiles = kHeld / 16;
static_assert(kBwdThreads == kFwdThreads, "compact_keys assumes the forward's block");
// The head geometry is the forward's (FwdShape): kSteps k-steps over the
// head dims (and dim n-tiles of the outputs), staged rows kStride floats
// apart, free of bank conflicts for both fragment reads.

// A B fragment (b0, b1) split: (hi0, hi1, lo0, lo1).
__device__ __forceinline__ uint4 split_b(float b0, float b1) {
  uint4 f;
  pcaudio::split_tf32(b0, f.x, f.z);
  pcaudio::split_tf32(b1, f.y, f.w);
  return f;
}

__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint4 b) {
  pcaudio::mma_3xtf32_k8(c, ah, al, b.x, b.y, b.z, b.w);
}

__device__ __forceinline__ void split_a(float x0, float x1, float x2, float x3,
                                        uint32_t (&h)[4], uint32_t (&l)[4]) {
  pcaudio::split_tf32(x0, h[0], l[0]);
  pcaudio::split_tf32(x1, h[1], l[1]);
  pcaudio::split_tf32(x2, h[2], l[2]);
  pcaudio::split_tf32(x3, h[3], l[3]);
}

// The key side of a pair tile: 16 key rows as the A fragments of S^T and
// dP^T (rows g, g + 8; dims t, t + 4 of each k-step) and as dQ's B fragment
// (per group kg of 8 keys, relabelled: k-column t is key 8 kg + 2t, t + 4 is
// key 8 kg + 2t + 1; column g is dim 8 dn + g).
template <int DH>
struct KeyFrags {
  static constexpr int KS = FwdShape<DH>::kSteps;
  uint32_t kh[KS][4], kl[KS][4], vh[KS][4], vl[KS][4];
  uint4 kb[2][KS];
};

// The query side of a pair tile, 16 queries in two n-tiles of 8: Q^T and
// G^T as the B fragments of S^T and dP^T (column g is query 8 nt + g; k t,
// t + 4 dims of a k-step), and G and Q as the B fragments of dV and dK (the
// n-tile's 8 queries are the k-step, relabelled as the keys of dQ: k t is
// query 8 nt + 2t, t + 4 query 8 nt + 2t + 1; column g is dim 8 dn + g).
// rv[nt]: lse·log2(e) of queries 8 nt + 2t, 8 nt + 2t + 1 (+inf for none),
// then D = g·out of the same two.
template <int DH>
struct QueryFrags {
  static constexpr int KS = FwdShape<DH>::kSteps;
  uint4 qs[2][KS], gp[2][KS], gv[2][KS], qk[2][KS];
  float4 rv[2];
};

// One pair tile: 16 keys (the mma's rows) x 16 queries (two 8-column
// n-tiles; `two` false: the second holds no query).  S^T = K Q^T and dP^T
// = V G^T, P^T = 2^(S^T c - lse2), dS^T = P^T (dP^T - D), each pair's exp
// once; then dV += P^T G and dK += dS^T Q (unscaled) over these queries,
// and dQ += dS K (unscaled) over these keys, with dS^T's 8x8 blocks
// transposed in registers.  Bits 0, 1 of rows_ok: key rows g, g + 8 hold a
// valid key (else their P is 0).
template <int DH>
__device__ __forceinline__ void pair_tile(const KeyFrags<DH>& kf, const QueryFrags<DH>& qf,
                                          bool two, unsigned rows_ok, float c,
                                          float (&dva)[FwdShape<DH>::kSteps][4],
                                          float (&dka)[FwdShape<DH>::kSteps][4],
                                          float (&dqa)[FwdShape<DH>::kSteps][4]) {
  constexpr int KS = FwdShape<DH>::kSteps;
  float ds[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    if (nt == 1 && !two) {
#pragma unroll
      for (int r = 0; r < 4; ++r) ds[1][r] = 0.f;
      break;
    }
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      mma3(s, kf.kh[st], kf.kl[st], qf.qs[nt][st]);
      mma3(dp, kf.vh[st], kf.vl[st], qf.gp[nt][st]);
    }
    const float4 rv = qf.rv[nt];
    float p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // C reg r: key row g + 8 (r >> 1), query 2t + (r & 1)
      const float l2 = (r & 1) ? rv.y : rv.x;
      const float D = (r & 1) ? rv.w : rv.z;
      p[r] = (rows_ok >> (r >> 1)) & 1u ? pcaudio::ex2(fmaf(s[r], c, -l2)) : 0.f;
      ds[nt][r] = p[r] * (dp[r] - D);
    }
    // P^T and dS^T as A fragments, the n-tile's queries the k-step
    // (relabelled: k-column t is query 2t, C regs 0, 2; t + 4 is 2t + 1)
    uint32_t ph[4], pl[4], dh[4], dl[4];
    split_a(p[0], p[2], p[1], p[3], ph, pl);
    split_a(ds[nt][0], ds[nt][2], ds[nt][1], ds[nt][3], dh, dl);
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) {
      mma3(dva[dn], ph, pl, qf.gv[nt][dn]);
      mma3(dka[dn], dh, dl, qf.qk[nt][dn]);
    }
  }
  // dQ: the 8x8 block (key group kg, query n-tile nt) of dS^T, transposed,
  // gives lane (g, t) dS[8 nt + g][8 kg + 2t], [8 kg + 2t + 1]: A rows g
  // (nt 0), g + 8 (nt 1), k-columns t, t + 4 in the relabelled key order
#pragma unroll
  for (int kg = 0; kg < 2; ++kg) {
    float x00 = ds[0][2 * kg], x01 = ds[0][2 * kg + 1];
    float x10 = ds[1][2 * kg], x11 = ds[1][2 * kg + 1];
    pcaudio::transpose8x8(x00, x01);
    if (two) pcaudio::transpose8x8(x10, x11);
    uint32_t ah[4], al[4];
    split_a(x00, x10, x01, x11, ah, al);
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) mma3(dqa[dn], ah, al, kf.kb[kg][dn]);
  }
}

// 16 staged key rows [16][kStride] (K at `ks`, V at `vs`) -> KeyFrags.
template <int DH>
__device__ __forceinline__ void key_frags(const float* ks, const float* vs, int g, int t,
                                          KeyFrags<DH>& f) {
  constexpr int KS = FwdShape<DH>::kSteps, STR = FwdShape<DH>::kStride;
#pragma unroll
  for (int st = 0; st < KS; ++st) {
    const int d0 = 8 * st + t, d1 = d0 + 4;  // d0 < DH always; d1 not at dh 4
    split_a(ks[g * STR + d0], ks[(g + 8) * STR + d0], d1 < DH ? ks[g * STR + d1] : 0.f,
            d1 < DH ? ks[(g + 8) * STR + d1] : 0.f, f.kh[st], f.kl[st]);
    split_a(vs[g * STR + d0], vs[(g + 8) * STR + d0], d1 < DH ? vs[g * STR + d1] : 0.f,
            d1 < DH ? vs[(g + 8) * STR + d1] : 0.f, f.vh[st], f.vl[st]);
  }
#pragma unroll
  for (int kg = 0; kg < 2; ++kg)
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) {
      const int d = 8 * dn + g, r = 8 * kg + 2 * t;
      f.kb[kg][dn] = d < DH ? split_b(ks[r * STR + d], ks[(r + 1) * STR + d]) : uint4{0, 0, 0, 0};
    }
}

// 16 query rows, Q at `qs` and G at `gs`, each row a head's DH floats `str`
// apart (a staged tile, or the rows in global memory), rows at or past
// `nrows` zero -> QueryFrags (without rv).
template <int DH>
__device__ __forceinline__ void query_frags(const float* qs, const float* gs, size_t str,
                                            int nrows, int g, int t, QueryFrags<DH>& f) {
  constexpr int KS = FwdShape<DH>::kSteps;
  auto at = [&](const float* base, int r, int d) {
    return r < nrows && d < DH ? base[r * str + d] : 0.f;
  };
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      const int r = 8 * nt + g, d0 = 8 * st + t;
      f.qs[nt][st] = split_b(at(qs, r, d0), at(qs, r, d0 + 4));
      f.gp[nt][st] = split_b(at(gs, r, d0), at(gs, r, d0 + 4));
      const int r0 = 8 * nt + 2 * t, d = 8 * st + g;
      f.gv[nt][st] = split_b(at(gs, r0, d), at(gs, r0 + 1, d));
      f.qk[nt][st] = split_b(at(qs, r0, d), at(qs, r0 + 1, d));
    }
}

// Lane l < 16 holds lse2 and D of query row l of a 16-row tile (lanes 16-31
// repeat them); each lane gathers those of its C columns into rv.
template <int DH>
__device__ __forceinline__ void row_terms(float l2, float D, int t, QueryFrags<DH>& f) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int r0 = 8 * nt + 2 * t;
    f.rv[nt] = make_float4(__shfl_sync(pcaudio::kFullMask, l2, r0),
                           __shfl_sync(pcaudio::kFullMask, l2, r0 + 1),
                           __shfl_sync(pcaudio::kFullMask, D, r0),
                           __shfl_sync(pcaudio::kFullMask, D, r0 + 1));
  }
}

// cp.async the head-h rows of slots [first, first + 16) (slot i is key
// offset list[i], or i with no mask) of K and V into `dst` ([16][kStride] K
// rows, then V rows); slots at or past `n` are zero-filled.
template <int DH>
__device__ __forceinline__ void stage_key_rows(float* dst, const float* __restrict__ k,
                                               const float* __restrict__ v,
                                               const uint16_t* list, bool listed,
                                               size_t key0, int H, int h, int first, int n,
                                               int lane) {
  constexpr int kVec = DH / 4, STR = FwdShape<DH>::kStride;
#pragma unroll
  for (int rep = 0; rep < kVec; ++rep) {  // 2 * 16 * kVec pieces, kVec a lane
    const int c = lane + 32 * rep;
    const int arr = c / (16 * kVec), rem = c % (16 * kVec);
    const int i = rem / kVec, piece = rem % kVec;
    const int slot = first + i;
    const float* src = k;
    int bytes = 0;
    if (slot < n) {
      const int j = listed ? list[slot] : slot;
      src = (arr ? v : k) + ((key0 + j) * H + h) * DH + piece * 4;
      bytes = 16;
    }
    pcaudio::cp_async16_zfill(dst + (arr * 16 + i) * STR + piece * 4, src, bytes);
  }
}

template <int DH>
__device__ __forceinline__ float head_dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

template <int DH>
constexpr size_t fewq_smem() {
  constexpr int KS = FwdShape<DH>::kSteps, STR = FwdShape<DH>::kStride;
  return (size_t)kHeldTiles * 4 * 2 * KS * 32 * 16  // the held queries' fragments
         + (size_t)kHeldTiles * 2 * 32 * 16          // their rv
         + (size_t)kBwdWarps * kBwdRing * 2 * 16 * STR * 4  // the warps' key rings
         + (size_t)kWindow * 2;                       // the key list
}

// Few queries (N <= 64: ISAB's MAB0, PMA).  blockIdx.x = (b * H + h) *
// splits + sp.  The block holds the queries of (b, h) as split fragments in
// shared memory (warp w builds query tile w), and warp w walks 16-key tiles
// w, w + 4, ... of the valid keys of key range sp through its own cp.async
// ring.  A key tile's dK and dV are complete after its pass over the held
// queries and are written once; dQ accumulates in registers over the tiles,
// then over the warps in order, into dq (splits == 1) or part_dq [splits,
// B, N, H*DH].  Masked keys get zero rows.
template <int DH>
__global__ void __launch_bounds__(kBwdThreads, 3)
mha_bwd_fewq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const unsigned char* __restrict__ mask,
                    const float* __restrict__ out, const float* __restrict__ lse,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    float* __restrict__ dk, float* __restrict__ dvo,
                    float* __restrict__ part_dq, int B, int N, int M, int H, int splits,
                    float scale) {
  using S = FwdShape<DH>;
  constexpr int KS = S::kSteps, STR = S::kStride;
  constexpr int kStage = 2 * 16 * STR;
  constexpr int kFr = 4 * 2 * KS;  // uint4 a lane per query tile: qs, gp, gv, qk
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* qfr = reinterpret_cast<uint4*>(smem);                 // [tile][kFr][32]
  float4* qrv = reinterpret_cast<float4*>(qfr + kHeldTiles * kFr * 32);  // [tile][2][32]
  float* ring = reinterpret_cast<float*>(qrv + kHeldTiles * 2 * 32);
  uint16_t* list = reinterpret_cast<uint16_t*>(ring + kBwdWarps * kBwdRing * kStage);
  __shared__ int counts[kBwdWarps];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int x = blockIdx.x;
  const int sp = x % splits;
  x /= splits;
  const int h = x % H, b = x / H;
  const int dv = H * DH;
  const int qtiles = (N + 15) / 16;
  const float c = scale * kLog2e;

  if (warp < qtiles) {  // the held query tile `warp`
    const int row0 = warp * 16;
    const size_t base = ((size_t)b * N + row0) * dv + h * DH;
    QueryFrags<DH> f;
    query_frags<DH>(q + base, dout + base, dv, N - row0, g, t, f);
    const int r = lane & 15;
    float l2 = INFINITY, D = 0.f;
    if (row0 + r < N) {
      l2 = lse[((size_t)b * H + h) * N + row0 + r] * kLog2e;
      D = head_dot<DH>(dout + base + (size_t)r * dv, out + base + (size_t)r * dv);
    }
    row_terms<DH>(l2, D, t, f);
    uint4* dst = qfr + warp * kFr * 32 + lane;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int st = 0; st < KS; ++st) {
        dst[((0 * 2 + nt) * KS + st) * 32] = f.qs[nt][st];
        dst[((1 * 2 + nt) * KS + st) * 32] = f.gp[nt][st];
        dst[((2 * 2 + nt) * KS + st) * 32] = f.gv[nt][st];
        dst[((3 * 2 + nt) * KS + st) * 32] = f.qk[nt][st];
      }
      qrv[(warp * 2 + nt) * 32 + lane] = f.rv[nt];
    }
  }
  __syncthreads();

  float dqa[kHeldTiles][KS][4];
#pragma unroll
  for (int i = 0; i < kHeldTiles; ++i)
#pragma unroll
    for (int st = 0; st < KS; ++st)
#pragma unroll
      for (int r = 0; r < 4; ++r) dqa[i][st][r] = 0.f;

  const int kb = (int)((long long)M * sp / splits);
  const int ke = (int)((long long)M * (sp + 1) / splits);
  const bool listed = mask != nullptr;
  float* myring = ring + warp * kBwdRing * kStage;
  for (int w0 = kb; w0 < ke; w0 += kWindow) {
    const int wn = min(kWindow, ke - w0);
    const size_t key0 = (size_t)b * M + w0;
    int n = wn;
    if (listed) {
      n = compact_keys(mask + key0, wn, list, counts);
      for (int j = threadIdx.x; j < wn; j += kBwdThreads)  // masked keys: zero rows
        if (!mask[key0 + j]) {
          const size_t o = (key0 + j) * dv + h * DH;
#pragma unroll
          for (int d = 0; d < DH; d += 4) {
            *reinterpret_cast<float4*>(dk + o + d) = make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(dvo + o + d) = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
    }
    const int mtiles = (n + 15) / 16;
    const int mine = warp < mtiles ? (mtiles - warp + kBwdWarps - 1) / kBwdWarps : 0;
    auto stage = [&](int i) {
      if (i < mine)
        stage_key_rows<DH>(myring + i % kBwdRing * kStage, k, v, list, listed, key0, H, h,
                           (warp + i * kBwdWarps) * 16, n, lane);
      pcaudio::cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < kBwdRing - 1; ++i) stage(i);
    for (int i = 0; i < mine; ++i) {
      __syncwarp();  // every lane is done reading tile i - 1's slot
      stage(i + kBwdRing - 1);
      pcaudio::cp_async_wait<kBwdRing - 1>();
      __syncwarp();
      const float* ks = myring + i % kBwdRing * kStage;
      KeyFrags<DH> kf;
      key_frags<DH>(ks, ks + 16 * STR, g, t, kf);
      const int slot0 = (warp + i * kBwdWarps) * 16;
      const unsigned rows_ok = (slot0 + g < n ? 1u : 0u) | (slot0 + g + 8 < n ? 2u : 0u);
      float dva[KS][4], dka[KS][4];
#pragma unroll
      for (int st = 0; st < KS; ++st)
#pragma unroll
        for (int r = 0; r < 4; ++r) dva[st][r] = dka[st][r] = 0.f;
#pragma unroll
      for (int qt = 0; qt < kHeldTiles; ++qt) {
        if (qt >= qtiles) break;
        QueryFrags<DH> qf;
        const uint4* src = qfr + qt * kFr * 32 + lane;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int st = 0; st < KS; ++st) {
            qf.qs[nt][st] = src[((0 * 2 + nt) * KS + st) * 32];
            qf.gp[nt][st] = src[((1 * 2 + nt) * KS + st) * 32];
            qf.gv[nt][st] = src[((2 * 2 + nt) * KS + st) * 32];
            qf.qk[nt][st] = src[((3 * 2 + nt) * KS + st) * 32];
          }
          qf.rv[nt] = qrv[(qt * 2 + nt) * 32 + lane];
        }
        pair_tile<DH>(kf, qf, qt * 16 + 8 < N, rows_ok, c, dva, dka, dqa[qt]);
      }
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {  // C rows g, g + 8: this tile's keys
        const int slot = slot0 + g + 8 * r2;
        if (slot >= n) continue;
        const size_t o = (key0 + (listed ? list[slot] : slot)) * dv + h * DH;
#pragma unroll
        for (int dn = 0; dn < KS; ++dn)
          if (8 * dn + 2 * t < DH) {
            *reinterpret_cast<float2*>(dk + o + 8 * dn + 2 * t) =
                make_float2(dka[dn][2 * r2] * scale, dka[dn][2 * r2 + 1] * scale);
            *reinterpret_cast<float2*>(dvo + o + 8 * dn + 2 * t) =
                make_float2(dva[dn][2 * r2], dva[dn][2 * r2 + 1]);
          }
      }
    }
    pcaudio::cp_async_wait<0>();
    __syncthreads();  // the list and the rings are free again
  }

  // dQ over the warps, in order: [warp][kHeld rows][DH] in the rings' space
  float* red = ring;
#pragma unroll
  for (int qt = 0; qt < kHeldTiles; ++qt)
#pragma unroll
    for (int dn = 0; dn < KS; ++dn)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int d = 8 * dn + 2 * t + (r & 1);
        if (d < DH) red[(warp * kHeld + qt * 16 + g + 8 * (r >> 1)) * DH + d] = dqa[qt][dn][r];
      }
  __syncthreads();
  for (int e = threadIdx.x; e < N * DH; e += kBwdThreads) {
    const int row = e / DH, d = e % DH;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) s += red[(w * kHeld + row) * DH + d];
    const size_t o = ((size_t)b * N + row) * dv + h * DH + d;
    if (splits == 1)
      dq[o] = s * scale;
    else
      part_dq[(size_t)sp * B * N * dv + o] = s;
  }
}

template <int DH>
constexpr size_t fewk_smem() {
  constexpr int KS = FwdShape<DH>::kSteps, STR = FwdShape<DH>::kStride;
  return (size_t)kHeldTiles * 6 * KS * 32 * 16                      // the held keys' fragments
         + (size_t)kBwdWarps * kBwdRing * (3 * 16 * STR + 16) * 4;  // the warps' query rings
}

// Few keys (M <= 64: ISAB's MAB1, whose keys are the inducing summaries).
// blockIdx.x = (b * H + h) * splits + sp.  The block holds the keys of
// (b, h) as split fragments in shared memory (warp w builds key tile w;
// masked keys zero), and warp w walks 16-query tiles w, w + 4, ... of query
// range sp through its own cp.async ring (Q, G and out rows and lse).  A
// query tile's dQ is complete after its pass over the held keys and is
// written once; dK and dV accumulate in registers over the tiles, then over
// the warps in order, into dk / dv (splits == 1) or part_dk / part_dv
// [splits, B, M, H*DH].
template <int DH>
__global__ void __launch_bounds__(kBwdThreads, 3)
mha_bwd_fewk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const unsigned char* __restrict__ mask,
                    const float* __restrict__ out, const float* __restrict__ lse,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    float* __restrict__ dk, float* __restrict__ dvo,
                    float* __restrict__ part_dk, float* __restrict__ part_dv, int B, int N,
                    int M, int H, int splits, float scale) {
  using S = FwdShape<DH>;
  constexpr int KS = S::kSteps, STR = S::kStride;
  constexpr int kStage = 3 * 16 * STR + 16;  // Q, G, out rows, then lse
  constexpr int kFr = 6 * KS;  // uint4 a lane per key tile: kh, kl, vh, vl per k-step; kb
  constexpr int kVec = DH / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* kfr = reinterpret_cast<uint4*>(smem);  // [tile][kFr][32]
  float* ring = reinterpret_cast<float*>(kfr + kHeldTiles * kFr * 32);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int x = blockIdx.x;
  const int sp = x % splits;
  x /= splits;
  const int h = x % H, b = x / H;
  const int dv = H * DH;
  const int mtiles = (M + 15) / 16;
  const float c = scale * kLog2e;
  auto valid = [&](int key) {
    return key < M && (mask == nullptr || mask[(size_t)b * M + key] != 0);
  };

  if (warp < mtiles) {  // the held key tile `warp`
    const int key0 = warp * 16;
    const float* kb = k + (size_t)b * M * dv + h * DH;
    const float* vb = v + (size_t)b * M * dv + h * DH;
    auto at = [&](const float* base, int key, int d) {
      return d < DH && valid(key) ? __ldg(base + (size_t)key * dv + d) : 0.f;
    };
    uint4* dst = kfr + warp * kFr * 32 + lane;
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      const int d0 = 8 * st + t, d1 = d0 + 4, k0 = key0 + g, k1 = k0 + 8;
      uint32_t hh[4], ll[4];
      split_a(at(kb, k0, d0), at(kb, k1, d0), at(kb, k0, d1), at(kb, k1, d1), hh, ll);
      dst[(2 * st) * 32] = make_uint4(hh[0], hh[1], hh[2], hh[3]);
      dst[(2 * st + 1) * 32] = make_uint4(ll[0], ll[1], ll[2], ll[3]);
      split_a(at(vb, k0, d0), at(vb, k1, d0), at(vb, k0, d1), at(vb, k1, d1), hh, ll);
      dst[(2 * KS + 2 * st) * 32] = make_uint4(hh[0], hh[1], hh[2], hh[3]);
      dst[(2 * KS + 2 * st + 1) * 32] = make_uint4(ll[0], ll[1], ll[2], ll[3]);
    }
#pragma unroll
    for (int kg = 0; kg < 2; ++kg)
#pragma unroll
      for (int dn = 0; dn < KS; ++dn) {
        const int d = 8 * dn + g, r = key0 + 8 * kg + 2 * t;
        dst[(4 * KS + kg * KS + dn) * 32] = split_b(at(kb, r, d), at(kb, r + 1, d));
      }
  }
  unsigned ok = 0;  // bit 2 mt + r2: key 16 mt + g + 8 r2 (this lane's C rows) is valid
#pragma unroll
  for (int mt = 0; mt < kHeldTiles; ++mt)
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) ok |= (unsigned)valid(16 * mt + g + 8 * r2) << (2 * mt + r2);
  __syncthreads();

  float dka[kHeldTiles][KS][4], dva[kHeldTiles][KS][4];
#pragma unroll
  for (int i = 0; i < kHeldTiles; ++i)
#pragma unroll
    for (int st = 0; st < KS; ++st)
#pragma unroll
      for (int r = 0; r < 4; ++r) dka[i][st][r] = dva[i][st][r] = 0.f;

  const int qb = (int)((long long)N * sp / splits);
  const int qe = (int)((long long)N * (sp + 1) / splits);
  const int first = qb + warp * 16, step = kBwdWarps * 16;
  const int mine = first < qe ? (qe - first + step - 1) / step : 0;
  const size_t hrow = ((size_t)b * H + h) * N;
  float* myring = ring + warp * kBwdRing * kStage;
  auto stage = [&](int i) {
    if (i < mine) {
      const int row0 = first + i * step;
      float* dst = myring + i % kBwdRing * kStage;
      for (int e = lane; e < 3 * 16 * kVec; e += 32) {
        const int arr = e / (16 * kVec), rem = e % (16 * kVec);
        const int r = rem / kVec, piece = rem % kVec;
        const float* src = arr == 0 ? q : arr == 1 ? dout : out;
        const bool in = row0 + r < qe;
        pcaudio::cp_async16_zfill(
            dst + (arr * 16 + r) * STR + piece * 4,
            in ? src + ((size_t)b * N + row0 + r) * dv + h * DH + piece * 4 : src,
            in ? 16 : 0);
      }
      if (lane < 16) {
        const bool in = row0 + lane < qe;
        pcaudio::cp_async4_zfill(dst + 3 * 16 * STR + lane, in ? lse + hrow + row0 + lane : lse,
                                 in ? 4 : 0);
      }
    }
    pcaudio::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kBwdRing - 1; ++i) stage(i);
  for (int i = 0; i < mine; ++i) {
    __syncwarp();  // every lane is done reading tile i - 1's slot
    stage(i + kBwdRing - 1);
    pcaudio::cp_async_wait<kBwdRing - 1>();
    __syncwarp();
    const float* qs = myring + i % kBwdRing * kStage;
    const float* gs = qs + 16 * STR;
    const float* os = gs + 16 * STR;
    const int row0 = first + i * step;
    QueryFrags<DH> qf;
    query_frags<DH>(qs, gs, STR, 16, g, t, qf);
    const int r = lane & 15;
    const float l2 = row0 + r < qe ? os[16 * STR + r] * kLog2e : INFINITY;
    row_terms<DH>(l2, head_dot<DH>(gs + r * STR, os + r * STR), t, qf);
    float dqa[KS][4];
#pragma unroll
    for (int st = 0; st < KS; ++st)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) dqa[st][rr] = 0.f;
#pragma unroll
    for (int mt = 0; mt < kHeldTiles; ++mt) {
      if (mt >= mtiles) break;
      KeyFrags<DH> kf;
      const uint4* src = kfr + mt * kFr * 32 + lane;
#pragma unroll
      for (int st = 0; st < KS; ++st) {
        const uint4 a = src[(2 * st) * 32], bb = src[(2 * st + 1) * 32];
        const uint4 va = src[(2 * KS + 2 * st) * 32], vb = src[(2 * KS + 2 * st + 1) * 32];
        kf.kh[st][0] = a.x, kf.kh[st][1] = a.y, kf.kh[st][2] = a.z, kf.kh[st][3] = a.w;
        kf.kl[st][0] = bb.x, kf.kl[st][1] = bb.y, kf.kl[st][2] = bb.z, kf.kl[st][3] = bb.w;
        kf.vh[st][0] = va.x, kf.vh[st][1] = va.y, kf.vh[st][2] = va.z, kf.vh[st][3] = va.w;
        kf.vl[st][0] = vb.x, kf.vl[st][1] = vb.y, kf.vl[st][2] = vb.z, kf.vl[st][3] = vb.w;
      }
#pragma unroll
      for (int kg = 0; kg < 2; ++kg)
#pragma unroll
        for (int dn = 0; dn < KS; ++dn) kf.kb[kg][dn] = src[(4 * KS + kg * KS + dn) * 32];
      pair_tile<DH>(kf, qf, row0 + 8 < qe, (ok >> (2 * mt)) & 3u, c, dva[mt], dka[mt], dqa);
    }
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {  // dQ's C rows g, g + 8: this tile's queries
      const int row = row0 + g + 8 * r2;
      if (row >= qe) continue;
      float* dst = dq + ((size_t)b * N + row) * dv + h * DH;
#pragma unroll
      for (int dn = 0; dn < KS; ++dn)
        if (8 * dn + 2 * t < DH)
          *reinterpret_cast<float2*>(dst + 8 * dn + 2 * t) =
              make_float2(dqa[dn][2 * r2] * scale, dqa[dn][2 * r2 + 1] * scale);
    }
  }
  pcaudio::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring

  // dK and dV over the warps, in order: [warp][kHeld keys][2][DH]
  float* red = ring;
#pragma unroll
  for (int mt = 0; mt < kHeldTiles; ++mt)
#pragma unroll
    for (int dn = 0; dn < KS; ++dn)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int d = 8 * dn + 2 * t + (rr & 1);
        const int key = mt * 16 + g + 8 * (rr >> 1);
        if (d < DH) {
          red[((warp * kHeld + key) * 2) * DH + d] = dka[mt][dn][rr];
          red[((warp * kHeld + key) * 2 + 1) * DH + d] = dva[mt][dn][rr];
        }
      }
  __syncthreads();
  for (int e = threadIdx.x; e < M * DH; e += kBwdThreads) {
    const int key = e / DH, d = e % DH;
    float sk = 0.f, sv = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) {
      sk += red[((w * kHeld + key) * 2) * DH + d];
      sv += red[((w * kHeld + key) * 2 + 1) * DH + d];
    }
    const size_t o = ((size_t)b * M + key) * dv + h * DH + d;
    if (splits == 1) {
      dk[o] = sk * scale;
      dvo[o] = sv;
    } else {
      part_dk[(size_t)sp * B * M * dv + o] = sk;
      part_dv[(size_t)sp * B * M * dv + o] = sv;
    }
  }
}

// The splits' partials, summed in split order: out_y[i] = mul_y * sum_s
// part_y[s][i] for tensor y = blockIdx.y (float4 i < n4).
__global__ void __launch_bounds__(256)
mha_bwd_merge_kernel(const float* __restrict__ part0, float* __restrict__ out0, float mul0,
                     const float* __restrict__ part1, float* __restrict__ out1, float mul1,
                     long long n4, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4* part = reinterpret_cast<const float4*>(blockIdx.y ? part1 : part0);
  const float mul = blockIdx.y ? mul1 : mul0;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < splits; ++sp) {
    const float4 x = __ldg(part + sp * n4 + i);
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  reinterpret_cast<float4*>(blockIdx.y ? out1 : out0)[i] =
      make_float4(s.x * mul, s.y * mul, s.z * mul, s.w * mul);
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

// Dynamic shared memory that brings a block (with its static shared
// memory) above the 48 KB default needs the kernel's consent; asked always.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// kind 0: the SIMT pair (dq, then dk/dv; `delta` scratch); 1: few queries; 2:
// few keys, with `splits` blocks splitting the large side (part_a, and
// part_b for kind 2, hold the partials).
template <int DH>
int bwd(const float* q, const float* k, const float* v, const unsigned char* mask,
        const float* out, const float* lse, const float* g, float* delta, float* dq,
        float* dk, float* dvo, float* part_a, float* part_b, int B, int N, int M, int H,
        int kind, int splits, float scale, cudaStream_t st) {
  if (kind == 0) {
    if (splits != 1 || delta == nullptr) return (int)cudaErrorInvalidValue;
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
  const long long n = (long long)B * H * splits;
  if (n > 0x7fffffffLL || (kind == 1 && N > kHeld) || (kind == 2 && M > kHeld) ||
      (splits > 1 && (part_a == nullptr || (kind == 2 && part_b == nullptr))))
    return (int)cudaErrorInvalidValue;
  const long long n4 = (long long)B * (kind == 1 ? N : M) * H * DH / 4;
  const dim3 merge_grid((unsigned)((n4 + 255) / 256), kind == 1 ? 1 : 2);
  if (kind == 1) {
    static const int attr = allow_smem(mha_bwd_fewq_kernel<DH>, fewq_smem<DH>());
    if (attr) return attr;
    mha_bwd_fewq_kernel<DH><<<(unsigned)n, kBwdThreads, fewq_smem<DH>(), st>>>(
        q, k, v, mask, out, lse, g, dq, dk, dvo, part_a, B, N, M, H, splits, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || splits == 1) return (int)e;
    mha_bwd_merge_kernel<<<merge_grid, 256, 0, st>>>(part_a, dq, scale, part_a, dq, scale,
                                                     n4, splits);
  } else if (kind == 2) {
    static const int attr = allow_smem(mha_bwd_fewk_kernel<DH>, fewk_smem<DH>());
    if (attr) return attr;
    mha_bwd_fewk_kernel<DH><<<(unsigned)n, kBwdThreads, fewk_smem<DH>(), st>>>(
        q, k, v, mask, out, lse, g, dq, dk, dvo, part_a, part_b, B, N, M, H, splits, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || splits == 1) return (int)e;
    mha_bwd_merge_kernel<<<merge_grid, 256, 0, st>>>(part_a, dk, scale, part_b, dvo, 1.f,
                                                     n4, splits);
  } else {
    return (int)cudaErrorInvalidValue;
  }
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

// The forward's inputs and results plus g = dL/dout.  Writes dq [B, N,
// H*dh], dk / dv [B, M, H*dh].  `kind` 1 (N <= 64) and 2 (M <= 64): the
// one-pass kernels, `splits` blocks splitting the large side (splits > 1:
// kind 1's part_a [splits, B, N, H*dh] for dq, kind 2's part_a and part_b
// [splits, B, M, H*dh] for dk and dv; else unused, may be null).  `kind` 0:
// the SIMT pair, delta [B, H, N] its scratch (splits 1).
extern "C" int pcaudio_mha_bwd(const void* q, const void* k, const void* v,
                               const void* mask, const void* out, const void* lse,
                               const void* g, void* delta, void* dq, void* dk, void* dv,
                               void* part_a, void* part_b, int B, int N, int M, int H,
                               int dh, int kind, int splits, float scale, void* stream) {
  if (B < 1 || N < 1 || M < 1 || H < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const auto m = (const unsigned char*)mask;
  const auto st = (cudaStream_t)stream;
#define PCAUDIO_MHA_BWD(DH)                                                            \
  return bwd<DH>((const float*)q, (const float*)k, (const float*)v, m,                   \
                 (const float*)out, (const float*)lse, (const float*)g, (float*)delta,   \
                 (float*)dq, (float*)dk, (float*)dv, (float*)part_a, (float*)part_b, B, \
                 N, M, H, kind, splits, scale, st)
  if (dh == 4) PCAUDIO_MHA_BWD(4);
  if (dh == 8) PCAUDIO_MHA_BWD(8);
  if (dh == 16) PCAUDIO_MHA_BWD(16);
#undef PCAUDIO_MHA_BWD
  return (int)cudaErrorInvalidValue;
}
