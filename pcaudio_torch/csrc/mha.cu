// Kernel K4: trainable masked multi-head set attention, forward and backward.
//
// Replaces the Pallas kernels of pcaudio/ops/kernels/mha.py::fused_mha
// (`_fwd_kernel` and `_bwd_kernel` under the custom VJP `_fused_mha`):
//   out_h = softmax_j(q_h[i] . k_h[j] * scale, masked keys left out) v_h
// with feature-split heads (head h owns features [h*dh, (h+1)*dh)), the
// reference's scale 1/sqrt(dim_V) passed in, and a row whose keys are all
// masked giving a zero output and zero gradients.  Everything is f32; the
// TPU kernel's bf16 operand rounding is not carried over.
//
// Three kernels, FlashAttention-2 style, none with atomics, so gradients are
// deterministic:
//   fwd   one block per (sample, head, query tile); an online softmax over
//         key tiles staged in shared memory; writes out and the row
//         log-sum-exp `lse` [B, H, N] (+inf for a row with no valid key);
//   dq    the same geometry; recomputes p = exp(s - lse), writes dq and the
//         row term D = g . out [B, H, N] that the dk/dv kernel reads;
//   dkdv  one block per (sample, head, key tile), looping over query tiles:
//         dv_j = sum_i p g_i, dk_j = sum_i p (g_i . v_j - D_i) q_i scale.
//
// What bounds it on the H100: with dh = 8 a (query, key) pair is about 20
// f32 operations against 64 bytes of K and V rows, so the work is f32 issue
// and shared-memory reads, not HBM (each sample's K and V are read once per
// query tile).  A thread's own head rows (its query, key, output and
// gradient rows) and the staged tiles move as 16-byte vectors.  At 3ST
// sizes (M = 5120 keys) one head's K and V are 160 KB each in f32, so keys are tiled (kTile rows of K and V in shared memory)
// instead of held whole as the TPU kernel holds them in VMEM.  dh = 8 is
// too narrow for tensor cores in this form, so each (query, head) pair goes
// to one thread with the key and value rows read as shared-memory
// broadcasts, as in K1.  Few queries (PMA: N = 1; MAB0: N = 64) would leave
// most threads idle, so a block of kThreads threads holds `qt` queries and
// splits each query's keys over kThreads / qt threads, whose partial
// softmax states are merged in shared memory at the end; the dk/dv kernel
// splits each key's queries the same way.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;   // key (fwd, dq) or query (dkdv) rows per stage

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

template <int DH>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const unsigned char* __restrict__ mask,
               float* __restrict__ out, float* __restrict__ lse, int N, int M,
               int H, int qt, float scale) {
  __shared__ __align__(16) float sm[kTile * (2 * DH + 1)];
  float* ks = sm;
  float* vs = ks + kTile * DH;
  float* mk = vs + kTile * DH;
  const Place p = place(N, H, qt);
  const int dv = H * DH;
  const size_t qrow = ((size_t)p.b * N + p.row) * dv + p.h * DH;

  float qs[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qs[d] = acc[d] = 0.f;
  if (p.active) load_row<DH>(qs, q + qrow, scale);
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < M; j0 += kTile) {
    const int nk = min(kTile, M - j0);
    __syncthreads();
    stage<DH>(k, v, ks, vs, p.b, M, H, p.h, j0, nk, 1.f);
    for (int r = threadIdx.x; r < nk; r += kThreads) mk[r] = key_ok(mask, p.b, M, j0 + r);
    __syncthreads();
    if (!p.active) continue;
    for (int j = p.split; j < nk; j += p.splits) {
      if (mk[j] == 0.f) continue;
      const float s = dot<DH>(qs, ks + j * DH);
      if (s > m) {  // rescale the running sums to the new maximum
        const float c = __expf(m - s);
        l *= c;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] *= c;
        m = s;
      }
      const float e = __expf(s - m);
      l += e;
      axpy<DH>(acc, e, vs + j * DH);
    }
  }

  // merge the splits of each query: slot's split 0 combines them in order
  __syncthreads();
  float* red = sm;  // kThreads * (DH + 2) floats fit in the tiles' space
  float* mine = red + threadIdx.x * (DH + 2);
  mine[0] = m;
  mine[1] = l;
#pragma unroll
  for (int d = 0; d < DH; ++d) mine[2 + d] = acc[d];
  __syncthreads();
  if (!p.active || p.split != 0) return;
  float mx = -INFINITY;
  for (int s = 0; s < p.splits; ++s) mx = fmaxf(mx, red[(s * qt + p.slot) * (DH + 2)]);
  float L = 0.f, A[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) A[d] = 0.f;
  if (mx > -INFINITY) {
    for (int s = 0; s < p.splits; ++s) {
      const float* o = red + (s * qt + p.slot) * (DH + 2);
      const float c = __expf(o[0] - mx);  // 0 for a split that saw no valid key
      L = fmaf(o[1], c, L);
#pragma unroll
      for (int d = 0; d < DH; ++d) A[d] = fmaf(o[2 + d], c, A[d]);
    }
  }
  store_row<DH>(out + qrow, A, L > 0.f ? 1.f / L : 0.f);
  lse[((size_t)p.b * H + p.h) * N + p.row] = L > 0.f ? mx + logf(L) : INFINITY;
}

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

template <int DH>
int fwd(const float* q, const float* k, const float* v, const unsigned char* mask,
        float* out, float* lse, int B, int N, int M, int H, float scale,
        cudaStream_t st) {
  const int qt = rows_per_block(N);
  unsigned blocks;
  if (const int e = grid_of(B, H, N, qt, &blocks)) return e;
  mha_fwd_kernel<DH><<<blocks, kThreads, 0, st>>>(q, k, v, mask, out, lse, N, M, H,
                                                  qt, scale);
  return (int)cudaGetLastError();
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

// q [B, N, H*dh], k / v [B, M, H*dh] f32 contiguous; mask [B, M] bytes or
// null (all keys valid).  out [B, N, H*dh], lse [B, H, N].
extern "C" int pcaudio_mha_fwd(const void* q, const void* k, const void* v,
                               const void* mask, void* out, void* lse, int B,
                               int N, int M, int H, int dh, float scale,
                               void* stream) {
  if (B < 1 || N < 1 || M < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const auto m = (const unsigned char*)mask;
  const auto st = (cudaStream_t)stream;
#define PCAUDIO_MHA_FWD(DH)                                                   \
  return fwd<DH>((const float*)q, (const float*)k, (const float*)v, m,          \
                 (float*)out, (float*)lse, B, N, M, H, scale, st)
  if (dh == 4) PCAUDIO_MHA_FWD(4);
  if (dh == 8) PCAUDIO_MHA_FWD(8);
  if (dh == 16) PCAUDIO_MHA_FWD(16);
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
