// Kernel K1: the whole Set Transformer forward, one thread block per cloud.
//
// Replaces the Pallas kernels pcaudio/ops/kernels/fused_st.py::
// fused_st_forward (`_make_kernel_v6`, serving, and `_make_kernel`, v4,
// masked).  ISAB -> ISAB -> PMA(1 seed) -> Linear with the reference MAB:
//   O = Qp + concat_h softmax(Qp_h Kp_h^T / sqrt(dv)) Vp_h,  out = O + relu(O Wo + bo)
// (feature-split heads, scale 1/sqrt(dv), projected-query residual).  The
// softmax is the exact max-subtract one with v4's mask semantics: masked
// keys are skipped, and a query whose keys are all masked attends to nothing
// (its attention output is 0, so MAB0 / PMA give the projected query).
// MAB1 is unmasked.  This replaces v6's exp(clip(lg, +-50)) serving
// shortcut, which equals the exact softmax for the O(10) logits it is used
// on; the max pass it saved costs little here.
//
// Everything is f32.  Points arrive f32 or bf16; the weights come packed in
// one f32 buffer (see pcaudio_torch/ops/kernels/fused_st.py), linear
// weights transposed to [in, out], with the batch-invariant query
// projections of the inducing points and of the seed precomputed.
//
// What bounds it on the H100: about 10 MFLOP-pairs (multiply-adds) per
// 128-point cloud and no HBM traffic beyond the points, the logits and the
// weights (about 200 KB, L2-resident), so it is bound by f32 issue and
// shared-memory reads.  The design keeps every intermediate of a cloud in
// shared memory (4 x [K, 64] + 2 x [M, 64] f32, 160 KB at K = 128, M = 64,
// so one block per SM), holds a projection's weight column in registers
// (each thread owns one output feature and walks rows, reading the input
// rows as shared-memory broadcasts), and gives each (query, head) pair to
// one thread, with the warp's 32 threads on 32 queries of one head so the
// key and value rows are broadcasts.  With 8-wide heads (dh = 8) the dot
// products are too short for tensor cores in this form; that is a later
// change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kDV = 64;              // hidden width
constexpr int kHeads = 8;
constexpr int kDH = kDV / kHeads;    // 8
constexpr int kThreads = 512;
constexpr int kRowGroups = kThreads / kDV;

// out[r, c] = in[r, :] . W[:, c] + b[c]                (kResidualRelu false)
// out[r, c] = in[r, c] + relu(in[r, :] . W[:, c] + b[c]) (true; KD == kDV)
// `in` is [rows, KD] and `out` [rows, kDV], row-major in shared memory, 16-byte
// aligned.  Each thread owns one output column and keeps its weights in
// registers; a warp reads each input row as broadcasts.
template <int KD, bool kResidualRelu>
__device__ __forceinline__ void project(const float* in, int rows,
                                        const float* __restrict__ W,
                                        const float* __restrict__ b, float* out) {
  const int c = threadIdx.x % kDV;
  const int rg = threadIdx.x / kDV;
  float w[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) w[k] = __ldg(W + k * kDV + c);
  const float bias = __ldg(b + c);
  for (int r = rg; r < rows; r += kRowGroups) {
    const float* x = in + r * KD;
    float acc = bias;
    if constexpr (KD % 4 == 0) {
#pragma unroll
      for (int k = 0; k < KD; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(x + k);
        acc = fmaf(v.x, w[k], acc);
        acc = fmaf(v.y, w[k + 1], acc);
        acc = fmaf(v.z, w[k + 2], acc);
        acc = fmaf(v.w, w[k + 3], acc);
      }
    } else {
#pragma unroll
      for (int k = 0; k < KD; ++k) acc = fmaf(x[k], w[k], acc);
    }
    if constexpr (kResidualRelu) {
      out[r * kDV + c] = x[c] + fmaxf(acc, 0.f);
    } else {
      out[r * kDV + c] = acc;
    }
  }
}

__device__ __forceinline__ float dot8(const float (&q)[kDH], const float* k) {
  const float4 a = *reinterpret_cast<const float4*>(k);
  const float4 b = *reinterpret_cast<const float4*>(k + 4);
  float l = q[0] * a.x;
  l = fmaf(q[1], a.y, l);
  l = fmaf(q[2], a.z, l);
  l = fmaf(q[3], a.w, l);
  l = fmaf(q[4], b.x, l);
  l = fmaf(q[5], b.y, l);
  l = fmaf(q[6], b.z, l);
  return fmaf(q[7], b.w, l);
}

// out[i, :] = q[i, :] + concat_h softmax_j(q_h[i] . k_h[j] * scale) v_h[j]
// for i < nq, over keys j < nk with maskf[j] != 0 (all keys if maskf is
// null).  q may live in global memory (the precomputed inducing / seed
// queries); k, v, maskf and out in shared memory, row stride kDV.  Pair
// p = (head, query) goes to one thread; a warp's threads share the head, so
// key and value reads are broadcasts.
__device__ __forceinline__ void attend(const float* q, int nq, const float* kb,
                                       const float* vb, int nk,
                                       const float* maskf, float* out,
                                       float scale) {
  static_assert(kDH == 8, "dot8 assumes 8-wide heads");
  for (int p = threadIdx.x; p < nq * kHeads; p += kThreads) {
    const int h = p / nq, i = p % nq;
    const float* qi = q + i * kDV + h * kDH;
    float qs[kDH];
#pragma unroll
    for (int d = 0; d < kDH; ++d) qs[d] = qi[d] * scale;
    float mx = -INFINITY;
    for (int j = 0; j < nk; ++j) {
      if (maskf != nullptr && maskf[j] == 0.f) continue;
      mx = fmaxf(mx, dot8(qs, kb + j * kDV + h * kDH));
    }
    float acc[kDH];
#pragma unroll
    for (int d = 0; d < kDH; ++d) acc[d] = 0.f;
    float s = 0.f;
    if (mx > -INFINITY) {
      for (int j = 0; j < nk; ++j) {
        if (maskf != nullptr && maskf[j] == 0.f) continue;
        const float e = __expf(dot8(qs, kb + j * kDV + h * kDH) - mx);
        const float4 v0 = *reinterpret_cast<const float4*>(vb + j * kDV + h * kDH);
        const float4 v1 = *reinterpret_cast<const float4*>(vb + j * kDV + h * kDH + 4);
        s += e;
        acc[0] = fmaf(e, v0.x, acc[0]);
        acc[1] = fmaf(e, v0.y, acc[1]);
        acc[2] = fmaf(e, v0.z, acc[2]);
        acc[3] = fmaf(e, v0.w, acc[3]);
        acc[4] = fmaf(e, v1.x, acc[4]);
        acc[5] = fmaf(e, v1.y, acc[5]);
        acc[6] = fmaf(e, v1.z, acc[6]);
        acc[7] = fmaf(e, v1.w, acc[7]);
      }
    }
    const float inv = s > 0.f ? 1.f / s : 0.f;
    float* oi = out + i * kDV + h * kDH;
#pragma unroll
    for (int d = 0; d < kDH; ++d) oi[d] = qi[d] + acc[d] * inv;
  }
}

struct Bufs {
  float *kb, *vb, *ha, *hb, *maskf;
};

// One ISAB on `in` ([K, KD]); the result lands in `tmp` ([K, kDV]), and
// `in` ([K, kDV] of space) is overwritten.  `w` walks the packed weights:
// iq [M, dv], MAB0 Wk bk Wv bv Wo bo, MAB1 Wq bq Wk bk Wv bv Wo bo.
template <int KD>
__device__ void isab(float* in, float* tmp, const Bufs& s, int K,
                     int M, const float*& w, float scale) {
  const float* iq = w;   w += M * kDV;
  const float* wk0 = w;  w += KD * kDV;
  const float* bk0 = w;  w += kDV;
  const float* wv0 = w;  w += KD * kDV;
  const float* bv0 = w;  w += kDV;
  const float* wo0 = w;  w += kDV * kDV;
  const float* bo0 = w;  w += kDV;
  const float* wq1 = w;  w += KD * kDV;
  const float* bq1 = w;  w += kDV;
  const float* wk1 = w;  w += kDV * kDV;
  const float* bk1 = w;  w += kDV;
  const float* wv1 = w;  w += kDV * kDV;
  const float* bv1 = w;  w += kDV;
  const float* wo1 = w;  w += kDV * kDV;
  const float* bo1 = w;  w += kDV;

  project<KD, false>(in, K, wk0, bk0, s.kb);
  project<KD, false>(in, K, wv0, bv0, s.vb);
  project<KD, false>(in, K, wq1, bq1, tmp);             // MAB1 queries
  __syncthreads();
  attend(iq, M, s.kb, s.vb, K, s.maskf, s.ha, scale);   // MAB0(I, X), masked
  __syncthreads();
  project<kDV, true>(s.ha, M, wo0, bo0, s.hb);     // H
  __syncthreads();
  project<kDV, false>(s.hb, M, wk1, bk1, s.kb);
  project<kDV, false>(s.hb, M, wv1, bv1, s.vb);
  __syncthreads();
  attend(tmp, K, s.kb, s.vb, M, nullptr, in, scale);    // MAB1(X, H)
  __syncthreads();
  project<kDV, true>(in, K, wo1, bo1, tmp);
  __syncthreads();
}

template <int DIN>
__global__ void __launch_bounds__(kThreads, 1)
fused_st_kernel(const void* __restrict__ points, int points_bf16,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ weights, float* __restrict__ out,
                int K, int M, int ncls) {
  extern __shared__ __align__(16) float sm[];
  const int R = K > M ? K : M;
  float* xa = sm;               // [K, dv]
  float* xb = xa + K * kDV;     // [K, dv]
  Bufs s;
  s.kb = xb + K * kDV;          // [R, dv]
  s.vb = s.kb + R * kDV;        // [R, dv]
  s.ha = s.vb + R * kDV;        // [M, dv]
  s.hb = s.ha + M * kDV;        // [M, dv]
  s.maskf = s.hb + M * kDV;     // [K]

  const int n = blockIdx.x;
  const size_t p0 = (size_t)n * K * DIN;
  for (int e = threadIdx.x; e < K * DIN; e += kThreads) {
    xa[e] = points_bf16
        ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(points)[p0 + e])
        : reinterpret_cast<const float*>(points)[p0 + e];
  }
  for (int j = threadIdx.x; j < K; j += kThreads) {
    s.maskf[j] = (mask == nullptr || mask[(size_t)n * K + j]) ? 1.f : 0.f;
  }
  __syncthreads();
  const float* mk = mask == nullptr ? nullptr : s.maskf;
  s.maskf = const_cast<float*>(mk);

  const float scale = rsqrtf((float)kDV);
  const float* w = weights;
  isab<DIN>(xa, xb, s, K, M, w, scale);   // -> xb
  isab<kDV>(xb, xa, s, K, M, w, scale);   // -> xa

  // PMA: one seed attends over the (masked) cloud, then the output Linear
  const float* sq = w;   w += kDV;
  const float* wkp = w;  w += kDV * kDV;
  const float* bkp = w;  w += kDV;
  const float* wvp = w;  w += kDV * kDV;
  const float* bvp = w;  w += kDV;
  const float* wop = w;  w += kDV * kDV;
  const float* bop = w;  w += kDV;
  const float* wd = w;   w += kDV * ncls;
  const float* bd = w;
  project<kDV, false>(xa, K, wkp, bkp, s.kb);
  project<kDV, false>(xa, K, wvp, bvp, s.vb);
  __syncthreads();
  attend(sq, 1, s.kb, s.vb, K, s.maskf, s.ha, scale);
  __syncthreads();
  project<kDV, true>(s.ha, 1, wop, bop, s.hb);
  __syncthreads();
  for (int c = threadIdx.x; c < ncls; c += kThreads) {
    float acc = __ldg(bd + c);
    for (int k = 0; k < kDV; ++k) acc = fmaf(s.hb[k], __ldg(wd + k * ncls + c), acc);
    out[(size_t)n * ncls + c] = acc;
  }
}

// Packed weight count; must match fused_st.py::_packed_weights.
long long packed_size(int din, int M, int ncls) {
  auto isab_size = [&](int kd) {
    return (long long)M * kDV + 3LL * (kd * kDV + kDV) + 4LL * (kDV * kDV + kDV);
  };
  return isab_size(din) + isab_size(kDV) + kDV + 3LL * (kDV * kDV + kDV) +
         (long long)kDV * ncls + ncls;
}

template <int DIN>
int launch(const void* points, int points_bf16, const unsigned char* mask,
           const float* weights, float* out, int N, int K, int M, int ncls,
           cudaStream_t stream) {
  const int R = K > M ? K : M;
  const size_t smem = (size_t)(2 * K * kDV + 2 * R * kDV + 2 * M * kDV + K) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      fused_st_kernel<DIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_st_kernel<DIN><<<N, kThreads, smem, stream>>>(points, points_bf16, mask,
                                                      weights, out, K, M, ncls);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pcaudio_fused_st(const void* points, int points_bf16,
                                const void* mask, const void* weights,
                                long long n_weights, void* out, int N, int K,
                                int din, int M, int ncls, void* stream) {
  if (N < 1 || K < 1 || M < 1 || ncls < 1) return (int)cudaErrorInvalidValue;
  if (n_weights != packed_size(din, M, ncls)) return (int)cudaErrorInvalidValue;
  const auto m = (const unsigned char*)mask;
  const auto w = (const float*)weights;
  const auto st = (cudaStream_t)stream;
  if (din == 2) return launch<2>(points, points_bf16, m, w, (float*)out, N, K, M, ncls, st);
  if (din == 3) return launch<3>(points, points_bf16, m, w, (float*)out, N, K, M, ncls, st);
  return (int)cudaErrorInvalidValue;
}
