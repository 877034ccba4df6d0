// Kernel K1: the whole Set Transformer forward, one block of 4 warps (8 when
// num_inds > 64) per cloud, bf16 tensor-core products with f32 sums.
//
// Replaces the Pallas kernels pcaudio/ops/kernels/fused_st.py::
// fused_st_forward (`_make_kernel_v6`, serving, and `_make_kernel`, v4,
// masked).  ISAB -> ISAB -> PMA(1 seed) -> Linear with the reference MAB:
//   O = Qp + concat_h softmax(Qp_h Kp_h^T / sqrt(dv)) Vp_h,  out = O + relu(O Wo + bo)
// (feature-split heads, scale 1/sqrt(dv), projected-query residual).  The
// softmax is the exact max-subtract one with v4's mask semantics: masked
// keys are skipped, and a query whose keys are all masked attends to nothing
// (MAB0 and the PMA then give the projected query).  MAB1 is unmasked.
//
// Precision is the JAX kernel's: bf16 operands, f32 sums, f32 softmax
// statistics, with bf16 rounding of the points, of each MAB's projected K
// and V, of the probabilities before A.V, of the input of every product
// (the rFF's, the queries' of the scores) and of each ISAB's output.  The
// probabilities are rounded unnormalised (relative to the running max of
// a 64-key chunk) and A.V divided by their f32 sum at the end, where the
// JAX kernel rounds them normalised; the PMA's A.V is an f32 sum (one
// query, no tensor-core product), so its probabilities stay f32.  The plain
// version (fused_st.py::fused_st_forward_plain) computes in this order.
//
// What bounds it on the H100: about 20 MFLOP of products a 128-point cloud
// (0.9 ms at the bench's 44,032 clouds on bf16 tensor cores) but 263,168
// softmax exps (MAB0 64 x 8 x K and MAB1 K x 8 x 64 per ISAB, twice, plus
// the PMA's 8 x K): 2.77 ms on the special-function units.  So the design
// spends one FFMA and one ex2 on each score and keeps the rest off shared
// memory:
//  - every product is mma.sync: projections m16n8k16 (16 rows of a warp x
//    64 outputs), scores m16n8k8 (k = the head width 8), P.V m16n8k16 (n =
//    the head width); a projection's C fragments are the A fragments of the
//    next product (the rFF, K and V of the next MAB, a head's queries), and
//    two score tiles' C fragments the A fragment of P.V, so no score and no
//    projection between two products touches shared memory;
//  - each score is computed once, with an online softmax over key chunks
//    of at most 64 (log2(e)/sqrt(64) applied in the FFMA that feeds ex2);
//  - keys that scale with the cloud (MAB0's and the PMA's) are projected a
//    tile of 16 x warps points at a time and consumed at once; only ISAB
//    1's output [K, 64] bf16 is kept for the cloud (18 KB at K = 128 with
//    its padded rows), so a cloud takes 57 KB of shared memory at K = 128
//    and three clouds are in flight on an SM; the limit is 1,280 points
//    (num_inds <= 64);
//  - the weights (136 KB in bf16) do not fit beside that; they are packed
//    in mma B-fragment order (fused_st.py::_packed_weights), one 8-byte
//    load a lane a product, read through L1 and L2.
// Measured (PERF.md), it takes 3.8 x the exp bound and is held by
// latency, not by the SFU: without its exps it is 10 % faster.  Three
// blocks of 4 warps an SM fill the register file (168 registers, with
// spills), each head's softmax is a chain of dependent steps (mma, max,
// shuffles, ex2, pack, mma), and the weight fragments come from L1 or L2.
// Two blocks an SM without spills measured slower.
// Three passes over the point tiles:
//   A  ISAB 1 MAB0: the inducing queries attend over the points' K0, V0;
//   B  ISAB 1 MAB1 (each point attends over H1) -> ISAB 1's output X1 ->
//      ISAB 2's MAB0 keys, consumed by its inducing queries at once;
//   C  ISAB 2 MAB1 over X1 -> X2 -> the PMA's keys, consumed by the seed
//      (per warp, then merged), then the PMA's rFF and the output Linear.
// A and B hold 80 registers of online state for the inducing queries and
// synchronise the block twice a tile; C needs no barrier until its end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma.cuh"

namespace {

using pcaudio::ex2;
using pcaudio::ldmatrix_x4;
using pcaudio::ldmatrix_x4_trans;
using pcaudio::mma_bf16_k16;
using pcaudio::mma_bf16_k8;
using pcaudio::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kDV = 64;             // hidden width
constexpr int kHeads = 8;
constexpr int kDH = kDV / kHeads;   // 8: one n = 8 tile is one head
constexpr int kLd = 72;             // bf16 row stride of the [rows, 64] buffers:
                                    // 144 bytes, so ldmatrix and the 32-bit
                                    // fragment stores hit 32 distinct banks
constexpr float kC = 1.4426950408889634f / 8.f;  // log2(e) / sqrt(dv)
constexpr int kFrag = 8 * 32 * 4;   // bf16 of one k16 step of a packed [., 64] weight
constexpr int kMaxSmem = 232448;    // 227 KB, a block's limit on the H100

__device__ __forceinline__ float bfr(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The 16 x 64 product a W + bias as eight 16 x 8 column tiles: f(j, c)
// gets tile j (columns 8j..8j+7) as a C fragment.  The eight mma chains
// are computed together (each k16 step feeds all of them), so each hides
// the others' latency; a consumer that takes a tile at a time (a store,
// the rFF's residual, one head) then holds no copy of the product.  a: the
// A fragments of 16 x 16KS bf16; W packed in B-fragment order.
template <int KS, typename F>
__device__ __forceinline__ void project_each(const uint32_t (&a)[KS][4],
                                             const uint2* __restrict__ w,
                                             const float* __restrict__ bias, F f) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  float c[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * t));
    c[j][0] = b.x; c[j][1] = b.y; c[j][2] = b.x; c[j][3] = b.y;
  }
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint2 wv = __ldg(w + (s * 8 + j) * 32 + lane);
      mma_bf16_k16(c[j], a[s], wv.x, wv.y);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) f(j, c[j]);
}

// c (16 rows x 64, C fragments: c[j] is columns 8j..8j+7) = a W + bias.
template <int KS>
__device__ __forceinline__ void project(const uint32_t (&a)[KS][4],
                                        const uint2* __restrict__ w,
                                        const float* __restrict__ bias,
                                        float (&c)[8][4]) {
  project_each<KS>(a, w, bias, [&](int j, const float (&r)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = r[e];
  });
}

// C fragments of 16 x 64 -> the bf16 A fragments of the same rows (k = 64).
__device__ __forceinline__ void to_afrag(const float (&c)[8][4], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a[s][0] = pack_bf16(c[2 * s][0], c[2 * s][1]);
    a[s][1] = pack_bf16(c[2 * s][2], c[2 * s][3]);
    a[s][2] = pack_bf16(c[2 * s + 1][0], c[2 * s + 1][1]);
    a[s][3] = pack_bf16(c[2 * s + 1][2], c[2 * s + 1][3]);
  }
}

// o += relu(bf16(o) W + b), in registers.
__device__ __forceinline__ void rff(float (&o)[8][4], const uint2* __restrict__ w,
                                    const float* __restrict__ b) {
  uint32_t a[4][4];
  to_afrag(o, a);
  project_each<4>(a, w, b, [&](int j, const float (&r)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] += fmaxf(r[e], 0.f);
  });
}

// Column tile j of the warp's 16 rows, rounded to bf16, into rows[0..16)
// of a kLd buffer.
__device__ __forceinline__ void store_tile(int j, const float (&c)[4], bf16* rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  *reinterpret_cast<uint32_t*>(rows + g * kLd + 8 * j + 2 * t) = pack_bf16(c[0], c[1]);
  *reinterpret_cast<uint32_t*>(rows + (g + 8) * kLd + 8 * j + 2 * t) = pack_bf16(c[2], c[3]);
}

// The warp's 16 rows, rounded to bf16, into rows[0..16) of a kLd buffer.
__device__ __forceinline__ void store_rows(const float (&c)[8][4], bf16* rows) {
#pragma unroll
  for (int j = 0; j < 8; ++j) store_tile(j, c[j], rows);
}

// rows[0..16) of a kLd buffer = bf16(a W + bias).
template <int KS>
__device__ __forceinline__ void project_rows(const uint32_t (&a)[KS][4],
                                             const uint2* __restrict__ w,
                                             const float* __restrict__ bias, bf16* rows) {
  project_each<KS>(a, w, bias, [&](int j, const float (&c)[4]) { store_tile(j, c, rows); });
}

// A fragments of rows[0..16) of a kLd buffer.
__device__ __forceinline__ void load_afrag(const bf16* rows, uint32_t (&a)[4][4]) {
  const int lane = threadIdx.x & 31;
  const bf16* p = rows + (lane & 15) * kLd + (lane >> 4) * 8;
#pragma unroll
  for (int s = 0; s < 4; ++s) ldmatrix_x4(a[s], p + 16 * s);
}

// One head h of a warp's 16 query rows over keys [0, nk) of Kt / Vt (nk a
// multiple of 16, at most 64), online.  qa: the head's bf16 queries as an
// m16n8k8 A fragment.  Key j counts iff j < nvalid and (valid == nullptr or
// valid[j]).  m: the running max of rows g, g + 8 (the same in a quad), l:
// this thread's share of the running sums, o: the unnormalised output.
__device__ __forceinline__ void attend_chunk(const uint32_t (&qa)[2], const bf16* Kt,
                                             const bf16* Vt, int h, int nk,
                                             const uint8_t* valid, int nvalid,
                                             float (&m)[2], float (&l)[2], float (&o)[4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  float s[8][4];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (q * 32 < nk) {
      uint32_t kb[4];  // B fragments of key groups 4q .. 4q + 3
      ldmatrix_x4(kb, Kt + (q * 32 + lane) * kLd + h * kDH);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[4 * q + i][0] = s[4 * q + i][1] = s[4 * q + i][2] = s[4 * q + i][3] = 0.f;
        mma_bf16_k8(s[4 * q + i], qa, kb[i]);
      }
    }
  }
  if (valid != nullptr || nk < 64 || nvalid < 64) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * jj + 2 * t + (e & 1);
        if (j >= nk || j >= nvalid || (valid != nullptr && !valid[j])) s[jj][e] = -INFINITY;
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    mx[0] = fmaxf(mx[0], fmaxf(s[jj][0], s[jj][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[jj][2], s[jj][3]));
  }
  float ms[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    ms[r] = mx[r] == -INFINITY ? 0.f : mx[r] * kC;   // all masked so far: p = 0
    alpha[r] = ex2(fmaf(m[r], kC, -ms[r]));
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[jj][e] = ex2(fmaf(s[jj][e], kC, -ms[e >> 1]));
      l[e >> 1] += s[jj][e];
    }
  }
  // the chunk's A.V starts from 0 and joins o in one f32 FFMA a value: the
  // tensor cores' f32 accumulation truncates, and o carried through the
  // chunks inside them would drift with the number of chunks
  float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (q * 32 < nk) {
      uint32_t vb[4];  // B fragments of k16 steps 2q (0, 1) and 2q + 1 (2, 3)
      ldmatrix_x4_trans(vb, Vt + (q * 32 + lane) * kLd + h * kDH);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int ks = 2 * q + kk;
        if (ks * 16 < nk) {
          const uint32_t a[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                                 pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                                 pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                                 pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
          mma_bf16_k16(pv, a, vb[2 * kk], vb[2 * kk + 1]);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = fmaf(o[e], alpha[e >> 1], pv[e]);
}

// MAB1 of a warp's 16 rows: q (the projected queries, f32) += the
// attention over the M inducing rows' Kh / Vh, head by head.
__device__ __forceinline__ void mab1(float (&q)[8][4], const bf16* Kh, const bf16* Vh,
                                     int M) {
  const int Mp = (M + 15) & ~15;
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    const uint32_t qa[2] = {pack_bf16(q[h][0], q[h][1]), pack_bf16(q[h][2], q[h][3])};
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < Mp; c0 += 64) {
      attend_chunk(qa, Kh + c0 * kLd, Vh + c0 * kLd, h, min(64, Mp - c0), nullptr, M - c0,
                   m, l, o);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / quad_sum(l[r]);   // M >= 1 unmasked keys
      q[h][2 * r] += o[2 * r] * inv;
      q[h][2 * r + 1] += o[2 * r + 1] * inv;
    }
  }
}

// The packed weights of one ISAB (fused_st.py::_packed_weights); KS0 k16
// steps for its input width (1 for 2 or 3, 4 for 64).
struct IsabW {
  const bf16* iqb;                               // [M, 64] projected inducing queries
  const uint2 *k0, *v0, *o0, *q1, *k1, *v1, *o1;  // fragment-packed
  const float *iq, *bk0, *bv0, *bo0, *bq1, *bk1, *bv1, *bo1;
};

template <int KS0>
__device__ __forceinline__ IsabW isab_weights(const bf16*& wb, const float*& wf, int M) {
  IsabW w;
  auto frag = [&](int ks) {
    const uint2* p = reinterpret_cast<const uint2*>(wb);
    wb += ks * kFrag;
    return p;
  };
  auto vec = [&](int n) {
    const float* p = wf;
    wf += n;
    return p;
  };
  w.iqb = wb; wb += M * kDV;
  w.k0 = frag(KS0); w.v0 = frag(KS0); w.o0 = frag(4);
  w.q1 = frag(KS0); w.k1 = frag(4); w.v1 = frag(4); w.o1 = frag(4);
  w.iq = vec(M * kDV);
  w.bk0 = vec(kDV); w.bv0 = vec(kDV); w.bo0 = vec(kDV);
  w.bq1 = vec(kDV); w.bk1 = vec(kDV); w.bv1 = vec(kDV); w.bo1 = vec(kDV);
  return w;
}

// MAB0 of one ISAB for the warp's 16 inducing queries, all heads: the
// queries, and the online state over the point tiles.
struct Mab0State {
  uint32_t qa[kHeads][2];
  float m[kHeads][2], l[kHeads][2], o[kHeads][4];

  __device__ __forceinline__ void init(const bf16* iqb, int M, int q0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + g + 8 * r;
        qa[h][r] = row < M ? *reinterpret_cast<const uint32_t*>(iqb + row * kDV + h * kDH + 2 * t)
                           : 0u;
        m[h][r] = -INFINITY;
        l[h][r] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[h][e] = 0.f;
    }
  }

  // the tile's kt keys in Kt / Vt; key j valid iff j < nvalid and
  // (valid == nullptr or valid[j])
  __device__ __forceinline__ void consume(const bf16* Kt, const bf16* Vt, int kt,
                                          const uint8_t* valid, int nvalid) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      for (int c0 = 0; c0 < kt; c0 += 64) {
        attend_chunk(qa[h], Kt + c0 * kLd, Vt + c0 * kLd, h, 64,
                     valid == nullptr ? nullptr : valid + c0, nvalid - c0, m[h], l[h], o[h]);
      }
    }
  }

  // H = iq + attention, H += relu(H Wo + bo); its K and V for MAB1 into
  // Kh / Vh rows q0 ..
  __device__ __forceinline__ void finish(const IsabW& w, int M, int q0, bf16* Kh, bf16* Vh) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float hq[8][4];
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sum = quad_sum(l[h][r]);
        const float inv = sum > 0.f ? 1.f / sum : 0.f;   // all keys masked: attend to nothing
        const int row = q0 + g + 8 * r;
        const float2 q = row < M
            ? *reinterpret_cast<const float2*>(w.iq + row * kDV + h * kDH + 2 * t)
            : make_float2(0.f, 0.f);
        hq[h][2 * r] = q.x + o[h][2 * r] * inv;
        hq[h][2 * r + 1] = q.y + o[h][2 * r + 1] * inv;
      }
    }
    rff(hq, w.o0, w.bo0);
    uint32_t a[4][4];
    to_afrag(hq, a);
    project_rows<4>(a, w.k1, w.bk1, Kh + q0 * kLd);
    project_rows<4>(a, w.v1, w.bv1, Vh + q0 * kLd);
  }
};

// The A fragment of points rows r0 .. r0 + 15 (DIN columns padded to 16),
// rounded to bf16; rows past K are 0.
template <int DIN>
__device__ __forceinline__ void load_points(const void* points, int points_bf16,
                                            size_t base, int K, int r0, uint32_t (&a)[1][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float x[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 2 * t + e;
      float v = 0.f;
      if (row < K && col < DIN) {
        const size_t i = base + (size_t)row * DIN + col;
        v = points_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(points)[i])
                        : reinterpret_cast<const float*>(points)[i];
      }
      x[r][e] = v;
    }
  }
  a[0][0] = pack_bf16(x[0][0], x[0][1]);
  a[0][1] = pack_bf16(x[1][0], x[1][1]);
  a[0][2] = a[0][3] = 0u;
}

__host__ __device__ constexpr int tile_rows(int warps) { return 16 * warps; }

__host__ __device__ inline size_t smem_bytes(int K, int warps) {
  const int kt = tile_rows(warps);
  const size_t kp = (size_t)(K + kt - 1) / kt * kt;
  return (kp + 4 * kt) * kLd * sizeof(bf16) + (warps * 80 + 128) * sizeof(float) + kp;
}

// One ISAB's MAB0 over the cloud, tile by tile: each warp projects its 16
// rows of the tile (A fragments from load_a(first row, a)) into the tile's
// K and V, then the warps that hold inducing queries consume the tile.  Ends
// with H's K and V for MAB1 in Kh / Vh.
template <int KS, int NW, typename LoadA>
__device__ __forceinline__ void mab0_pass(const IsabW& w, LoadA load_a, int K, int M, int Kp,
                                          const uint8_t* kv, bf16* Kt, bf16* Vt, bf16* Kh,
                                          bf16* Vh) {
  constexpr int kT = tile_rows(NW);
  const int q0 = (threadIdx.x >> 5) * 16;   // this warp's rows and inducing queries
  const bool has_q = q0 < M;                // warp-uniform
  Mab0State st;
  st.init(w.iqb, M, q0);
  for (int p0 = 0; p0 < Kp; p0 += kT) {
    uint32_t a[KS][4];
    load_a(p0 + q0, a);
    project_rows<KS>(a, w.k0, w.bk0, Kt + q0 * kLd);
    project_rows<KS>(a, w.v0, w.bv0, Vt + q0 * kLd);
    __syncthreads();
    if (has_q) st.consume(Kt, Vt, kT, kv == nullptr ? nullptr : kv + p0, K - p0);
    __syncthreads();
  }
  if (has_q) st.finish(w, M, q0, Kh, Vh);
  __syncthreads();
}

// passes < 3 stops after that many passes (stage timing); the logits are
// then left unwritten.
template <int DIN, int NW>
__global__ void __launch_bounds__(NW * 32, NW == 4 ? 3 : 1)
fused_st_kernel(const void* __restrict__ points, int points_bf16,
                const uint8_t* __restrict__ mask, const bf16* __restrict__ wbuf,
                const float* __restrict__ fbuf, float* __restrict__ out, int K, int M,
                int ncls, int passes) {
  constexpr int kT = tile_rows(NW);
  constexpr int KS0 = (DIN + 15) / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Kp = (K + kT - 1) / kT * kT;
  bf16* X1 = reinterpret_cast<bf16*>(smem);   // [Kp][kLd] ISAB 1's output
  bf16* Kt = X1 + Kp * kLd;                   // [kT][kLd] a tile's MAB0 keys
  bf16* Vt = Kt + kT * kLd;
  bf16* Kh = Vt + kT * kLd;                   // [kT][kLd] MAB1's keys (M <= kT)
  bf16* Vh = Kh + kT * kLd;
  float* red = reinterpret_cast<float*>(Vh + kT * kLd);   // [NW][80] PMA partials
  float* vec = red + NW * 80;                             // [2][64]
  uint8_t* kvalid = reinterpret_cast<uint8_t*>(vec + 128);  // [Kp]

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int n = blockIdx.x;
  for (int j = threadIdx.x; j < Kp; j += NW * 32) {
    kvalid[j] = j < K && (mask == nullptr || mask[(size_t)n * K + j]);
  }
  const uint8_t* kv = mask == nullptr ? nullptr : kvalid;   // keys >= K cut by nvalid
  const size_t pbase = (size_t)n * K * DIN;

  const bf16* wb = wbuf;   // walked through the packed weights
  const float* wf = fbuf;
  const IsabW w1 = isab_weights<KS0>(wb, wf, M);
  const IsabW w2 = isab_weights<4>(wb, wf, M);
  const bf16* sqb = wb;  wb += kDV;
  const uint2* wkp = reinterpret_cast<const uint2*>(wb);  wb += 4 * kFrag;
  const uint2* wvp = reinterpret_cast<const uint2*>(wb);  wb += 4 * kFrag;
  const bf16* wop = wb;  wb += kDV * kDV;                  // [in, out]
  const bf16* wd = wb;                                     // [64, ncls]
  const float* sq = wf;  wf += kDV;
  const float* bkp = wf; wf += kDV;
  const float* bvp = wf; wf += kDV;
  const float* bop = wf; wf += kDV;
  const float* bd = wf;
  const int q0 = warp * 16;   // this warp's first row of a tile
  __syncthreads();

  // ---- A: ISAB 1's MAB0 over the points -----------------------------------
  mab0_pass<KS0, NW>(
      w1, [&](int r0, uint32_t (&a)[KS0][4]) {
        load_points<DIN>(points, points_bf16, pbase, K, r0, a);
      },
      K, M, Kp, kv, Kt, Vt, Kh, Vh);
  if (passes < 2) return;

  // ---- B: ISAB 1's MAB1 -> X1 -> ISAB 2's MAB0 ------------------------------
  // each warp's rows of a tile go through MAB1 and the rFF, are kept as X1
  // and projected at once into the tile's keys for ISAB 2's inducing queries
  mab0_pass<4, NW>(
      w2, [&](int r0, uint32_t (&a)[4][4]) {
        float x[8][4];
        {
          uint32_t ap[KS0][4];
          load_points<DIN>(points, points_bf16, pbase, K, r0, ap);
          project<KS0>(ap, w1.q1, w1.bq1, x);
        }
        mab1(x, Kh, Vh, M);
        rff(x, w1.o1, w1.bo1);
        store_rows(x, X1 + r0 * kLd);
        to_afrag(x, a);   // bf16(X1), as stored
      },
      K, M, Kp, kv, Kt, Vt, Kh, Vh);
  if (passes < 3) return;

  // ---- C: ISAB 2's MAB1 -> X2 -> the PMA, each warp on its own rows ---------
  float sqv[kHeads][2];             // bf16 seed query, columns 8h + 2t, + 1
  float pm[kHeads], pl[kHeads], pacc[kHeads][2];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    sqv[h][0] = __bfloat162float(sqb[h * kDH + 2 * t]);
    sqv[h][1] = __bfloat162float(sqb[h * kDH + 2 * t + 1]);
    pm[h] = -INFINITY;
    pl[h] = pacc[h][0] = pacc[h][1] = 0.f;
  }
  for (int r0 = q0; r0 < Kp; r0 += kT) {
    float x[8][4];
    {
      uint32_t a[4][4];
      load_afrag(X1 + r0 * kLd, a);
      project<4>(a, w2.q1, w2.bq1, x);
    }
    mab1(x, Kh, Vh, M);
    rff(x, w2.o1, w2.bo1);
    uint32_t a[4][4];
    to_afrag(x, a);          // bf16(X2)
    bool ok[2];   // rows g, g + 8 are valid keys
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      ok[r] = row < K && (kv == nullptr || kv[row]);
    }
    float sc[kHeads][2];   // the seed's scores of rows g, g + 8, head by head
    project_each<4>(a, wkp, bkp, [&](int h, const float (&kp)[4]) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float d = quad_sum(sqv[h][0] * bfr(kp[2 * r]) + sqv[h][1] * bfr(kp[2 * r + 1]));
        sc[h][r] = ok[r] ? d : -INFINITY;
      }
    });
    project_each<4>(a, wvp, bvp, [&](int h, const float (&vp)[4]) {
      float mx = fmaxf(sc[h][0], sc[h][1]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(pm[h], mx);
      const float ms = mn == -INFINITY ? 0.f : mn * kC;
      const float alpha = ex2(fmaf(pm[h], kC, -ms));
      pm[h] = mn;
      const float p0 = ex2(fmaf(sc[h][0], kC, -ms)), p1 = ex2(fmaf(sc[h][1], kC, -ms));
      pl[h] = pl[h] * alpha + p0 + p1;
      pacc[h][0] = pacc[h][0] * alpha + p0 * bfr(vp[0]) + p1 * bfr(vp[2]);
      pacc[h][1] = pacc[h][1] * alpha + p0 * bfr(vp[1]) + p1 * bfr(vp[3]);
    });
  }
  // this warp's (max, sum, output) per head, summed over the rows g
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      pl[h] += __shfl_xor_sync(0xffffffffu, pl[h], o);
      pacc[h][0] += __shfl_xor_sync(0xffffffffu, pacc[h][0], o);
      pacc[h][1] += __shfl_xor_sync(0xffffffffu, pacc[h][1], o);
    }
    if (g == 0) {
      float* r = red + warp * 80;
      if (t == 0) {
        r[h] = pm[h];
        r[8 + h] = pl[h];
      }
      r[16 + h * kDH + 2 * t] = pacc[h][0];
      r[16 + h * kDH + 2 * t + 1] = pacc[h][1];
    }
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d < kDV) {   // merge the warps: the PMA's attention output, + sq
    const int h = d / kDH;
    float mx = -INFINITY;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, red[w * 80 + h]);
    const float ms = mx == -INFINITY ? 0.f : mx * kC;
    float sum = 0.f, acc = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float f = ex2(fmaf(red[w * 80 + h], kC, -ms));
      sum += red[w * 80 + 8 + h] * f;
      acc += red[w * 80 + 16 + d] * f;
    }
    vec[d] = sq[d] + (sum > 0.f ? acc / sum : 0.f);
  }
  __syncthreads();
  if (d < kDV) {   // the PMA's rFF
    float r = bop[d];
    for (int k = 0; k < kDV; ++k) r = fmaf(bfr(vec[k]), __bfloat162float(wop[k * kDV + d]), r);
    vec[kDV + d] = vec[d] + fmaxf(r, 0.f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < ncls; c += NW * 32) {   // the output Linear
    float r = bd[c];
    for (int k = 0; k < kDV; ++k) {
      r = fmaf(bfr(vec[kDV + k]), __bfloat162float(wd[k * ncls + c]), r);
    }
    out[(size_t)n * ncls + c] = r;
  }
}

// Packed sizes, bf16 and f32; must match fused_st.py::_packed_weights.
long long packed_bf16(int din, int M, int ncls) {
  auto isab = [&](int ks0) { return (long long)M * kDV + (3LL * ks0 + 16) * kFrag; };
  return isab((din + 15) / 16) + isab(4) + kDV + 8LL * kFrag + kDV * kDV +
         (long long)kDV * ncls;
}
long long packed_f32(int M, int ncls) {
  return 2 * ((long long)M * kDV + 7 * kDV) + 4 * kDV + ncls;
}

template <int DIN, int NW>
int launch(const void* points, int points_bf16, const uint8_t* mask, const bf16* wb,
           const float* wf, float* out, int N, int K, int M, int ncls, int passes,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(K, NW);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      fused_st_kernel<DIN, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_st_kernel<DIN, NW><<<N, NW * 32, smem, stream>>>(points, points_bf16, mask, wb, wf,
                                                         out, K, M, ncls, passes);
  return (int)cudaGetLastError();
}

}  // namespace

// The most points a cloud may have for num_inds M (the shared memory of
// one block); 0 if M is outside 1 .. 128.
extern "C" int pcaudio_fused_st_max_points(int M) {
  if (M < 1 || M > 128) return 0;
  const int warps = M <= 64 ? 4 : 8, kt = tile_rows(warps);
  int k = 0;
  while (smem_bytes(k + kt, warps) <= kMaxSmem) k += kt;
  return k;
}

extern "C" int pcaudio_fused_st(const void* points, int points_bf16, const void* mask,
                                const void* wb, long long n_bf16, const void* wf,
                                long long n_f32, void* out, int N, int K, int din, int M,
                                int ncls, int passes, void* stream) {
  if (N < 1 || K < 1 || ncls < 1 || ncls > 256 || passes < 1 || passes > 3 ||
      K > pcaudio_fused_st_max_points(M))
    return (int)cudaErrorInvalidValue;
  if (n_bf16 != packed_bf16(din, M, ncls) || n_f32 != packed_f32(M, ncls))
    return (int)cudaErrorInvalidValue;
  const auto m = (const uint8_t*)mask;
  const auto b = (const bf16*)wb;
  const auto f = (const float*)wf;
  const auto st = (cudaStream_t)stream;
  const bool wide = M > 64;
  if (din == 2) {
    return wide ? launch<2, 8>(points, points_bf16, m, b, f, (float*)out, N, K, M, ncls, passes, st)
                : launch<2, 4>(points, points_bf16, m, b, f, (float*)out, N, K, M, ncls, passes, st);
  }
  if (din == 3) {
    return wide ? launch<3, 8>(points, points_bf16, m, b, f, (float*)out, N, K, M, ncls, passes, st)
                : launch<3, 4>(points, points_bf16, m, b, f, (float*)out, N, K, M, ncls, passes, st);
  }
  return (int)cudaErrorInvalidValue;
}
