// The mma.sync design of csrc/probe_attend.cu before its wgmma redesign (git 1bc6fde),
// kept verbatim below so that probes/probe_stages.py and chip_smoke.py phase 8 can
// build it as its own library and time it beside the redesign in one process.
// P3: the H100 counterpart of scripts/probe_int8_attend.py:53
// (`make_kernel(mode)`), the v6 attend stage run in bf16 or int8 with the
// script's arithmetic:
//
//   for g < steps, p < pairs:  k_p = kmat[((g mod pairs) + p) * 128 : +128]
//     bf16: lg = bf16(iq) . bf16(k_p)^T (f32) * 0.125
//           a  = exp(clip(lg, +-50)) / rowsum;  av = bf16(a) . bf16(k_p)
//     int8: (iq8, s_q) = quant(iq), (k8, s_k) = quant(k_p),
//           quant(x): s = max|x| * (1/127) + 1e-30, q = rint(x * (1/s));
//           lg = int32(iq8 . k8^T) * (s_q * s_k * 0.125), a as above,
//           a8 = rint(a * 127);  av = int32(a8 . k8) * (s_k / 127)
//   out [rows, 128] f32 = sum over g and p of av.
//
// Rounding is half to even (__float2int_rn, as jnp.round and torch.round;
// CUDA's roundf rounds halves away from zero), multiplies and adds are kept
// apart (__fmul_rn, __fadd_rn: no FMA contraction) and the division is
// IEEE, so quantisation matches the plain version bit for bit.
//
// What bounds it on the H100: operations.  8,192 attends of 2 x 1024 x
// 128 x 128 multiply-adds (550 GFLOP) on the tensor cores (bf16 989
// TFLOP/s, s8 1,979 TOP/s dense, through wgmma; mma.sync here), and 1.07 G
// exps on the special-function units (MUFU, 16 a clock per SM).
//
// Design: a block holds 128 query rows (8 warps of 16) for steps / groups
// consecutive grid steps; iq's fragments stay in registers throughout (in
// int8 mode quantised once, by a first one-block kernel, as the script
// hoists it).  Per window the block stages k_p into shared memory twice,
// key-major for the logits and dv-major for A.V (ldmatrix has no transpose
// for 8-bit data), quantising it first in int8 mode (a block max).  The
// logits' m16n8 accumulator tiles become A.V's A fragments in registers:
// directly for bf16; for s8 (k32 fragments hold four consecutive k) the
// keys are permuted, and the dv-major copy is stored in the same
// permutation, so the contraction is unchanged.  Each block adds its rows'
// sum into out with atomics (f32: the order of the `groups` additions
// varies from run to run).
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace pcaudio;

constexpr int kDv = 128, kKeys = 128, kBlockRows = 128, kThreads = 256;
constexpr float kInv127 = (float)(1.0 / 127.0);

__device__ __forceinline__ float quant_scale(float absmax) {
  return __fadd_rn(__fmul_rn(absmax, kInv127), 1e-30f);
}

__global__ void __launch_bounds__(1024) quant_kernel(const float* __restrict__ x, int n,
                                                     int8_t* __restrict__ q,
                                                     float* __restrict__ scale) {
  __shared__ float buf[32];
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = fmaxf(m, fabsf(x[i]));
  const float s = quant_scale(block_max(m, buf));
  const float inv = 1.0f / s;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    q[i] = (int8_t)__float2int_rn(__fmul_rn(x[i], inv));
  if (threadIdx.x == 0) *scale = s;
}

// Position of key j in the s8 A.V contraction (see the header comment):
// the logits' C registers of thread t hold keys 8n + 2t, +1 of n-tile n,
// and an s8 A register holds k positions 4t..4t+3.
__device__ __forceinline__ int s8_position(int j) {
  const int r = j & 31;
  return (j & ~31) + (r & 16) + ((r & 7) >> 1) * 4 + ((r >> 3) & 1) * 2 + (r & 1);
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
attend_kernel(const float* __restrict__ iq, const int8_t* __restrict__ iq8,
              const float* __restrict__ sq, const float* __restrict__ kmat,
              float* __restrict__ out, int pairs, int steps_per_block) {
  using Mma = typename std::conditional<kInt8, MmaS8, MmaBf16>::type;
  constexpr int kEl = kInt8 ? 1 : 2;
  constexpr int kRowB = kKeys * kEl + 16;  // padded shared-memory row
  constexpr int kQSteps = kDv * kEl / 32;  // k-steps of the logits (over dv)
  constexpr int kPSteps = kKeys * kEl / 32;  // k-steps of A.V (over keys)
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sk = smem;                   // [key][dv]
  uint8_t* skt = smem + kKeys * kRowB;  // [dv][key position]
  __shared__ float red[32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBlockRows + warp * 16;

  uint32_t qa[kQSteps][4];
#pragma unroll
  for (int kk = 0; kk < kQSteps; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = row0 + g + 8 * (q & 1);
      if constexpr (kInt8) {
        qa[kk][q] = *reinterpret_cast<const uint32_t*>(iq8 + row * kDv + kk * 32 +
                                                        16 * (q >> 1) + 4 * t);
      } else {
        const float2 v = *reinterpret_cast<const float2*>(iq + row * kDv + kk * 16 +
                                                          8 * (q >> 1) + 2 * t);
        qa[kk][q] = pack_bf16(v.x, v.y);
      }
    }
  const float s_q = kInt8 ? *sq : 0.f;

  float acc[kDv / 8][4] = {};
  const int g0 = blockIdx.y * steps_per_block;
  for (int gs = 0; gs < steps_per_block; ++gs) {
    for (int p = 0; p < pairs; ++p) {
      const float4* kp = reinterpret_cast<const float4*>(
          kmat + (long long)(((g0 + gs) % pairs) + p) * kKeys * kDv);
      __syncthreads();  // the previous window's readers are done
      float s_k = 1.f, inv = 1.f;
      if constexpr (kInt8) {
        float m = 0.f;
        for (int i = threadIdx.x; i < kKeys * kDv / 4; i += kThreads) {
          const float4 v = kp[i];
          m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
        }
        s_k = quant_scale(block_max(m, red));
        inv = 1.0f / s_k;
      }
      for (int i = threadIdx.x; i < kKeys * kDv / 4; i += kThreads) {
        const float4 v4 = kp[i];
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
        const int j = i / (kDv / 4), c = (i % (kDv / 4)) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kInt8) {
            const int8_t q = (int8_t)__float2int_rn(__fmul_rn(v[e], inv));
            sk[j * kRowB + c + e] = (uint8_t)q;
            skt[(c + e) * kRowB + s8_position(j)] = (uint8_t)q;
          } else {
            const __nv_bfloat16 b = __float2bfloat16_rn(v[e]);
            reinterpret_cast<__nv_bfloat16*>(sk + j * kRowB)[c + e] = b;
            reinterpret_cast<__nv_bfloat16*>(skt + (c + e) * kRowB)[j] = b;
          }
        }
      }
      __syncthreads();

      typename Mma::Acc s[kKeys / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk)
#pragma unroll
        for (int np = 0; np < kKeys / 16; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, b_frag_row(sk + np * 16 * kRowB + kk * 32, kRowB, lane));
          Mma::mma(s[2 * np], qa[kk], bf);
          Mma::mma(s[2 * np + 1], qa[kk], bf + 2);
        }

      // softmax over the 128 keys of rows g (regs 0, 1) and g + 8 (2, 3);
      // a row's keys are spread over the four threads of a quad
      const float scale = kInt8 ? __fmul_rn(__fmul_rn(s_q, s_k), 0.125f) : 0.125f;
      float e[kKeys / 8][4];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nj = 0; nj < kKeys / 8; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float lg = __fmul_rn((float)s[nj][q], scale);
          e[nj][q] = expf(fminf(fmaxf(lg, -50.f), 50.f));
          sum[q >> 1] += e[nj][q];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(kFullMask, sum[h], 1);
        sum[h] += __shfl_xor_sync(kFullMask, sum[h], 2);
      }
#pragma unroll
      for (int nj = 0; nj < kKeys / 8; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) e[nj][q] = e[nj][q] / sum[q >> 1];

      uint32_t pa[kPSteps][4];
      if constexpr (kInt8) {
        auto a8 = [&](int nj, int q) { return __float2int_rn(__fmul_rn(e[nj][q], 127.f)); };
#pragma unroll
        for (int kk = 0; kk < kPSteps; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // reg q: rows g / g+8 (q & 1), key half q >> 1 of step kk
            const int n = 4 * kk + 2 * (q >> 1), c = 2 * (q & 1);
            pa[kk][q] = pack_s8(a8(n, c), a8(n, c + 1), a8(n + 1, c), a8(n + 1, c + 1));
          }
        int av[kDv / 8][4] = {};
#pragma unroll
        for (int kk = 0; kk < kPSteps; ++kk)
#pragma unroll
          for (int np = 0; np < kDv / 16; ++np) {
            uint32_t bf[4];
            ldmatrix_x4(bf, b_frag_row(skt + np * 16 * kRowB + kk * 32, kRowB, lane));
            MmaS8::mma(av[2 * np], pa[kk], bf);
            MmaS8::mma(av[2 * np + 1], pa[kk], bf + 2);
          }
        const float sv = s_k / 127.f;
#pragma unroll
        for (int nj = 0; nj < kDv / 8; ++nj)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[nj][q] += __fmul_rn((float)av[nj][q], sv);
      } else {
#pragma unroll
        for (int kk = 0; kk < kPSteps; ++kk) {
          pa[kk][0] = pack_bf16(e[2 * kk][0], e[2 * kk][1]);
          pa[kk][1] = pack_bf16(e[2 * kk][2], e[2 * kk][3]);
          pa[kk][2] = pack_bf16(e[2 * kk + 1][0], e[2 * kk + 1][1]);
          pa[kk][3] = pack_bf16(e[2 * kk + 1][2], e[2 * kk + 1][3]);
        }
#pragma unroll
        for (int kk = 0; kk < kPSteps; ++kk)
#pragma unroll
          for (int np = 0; np < kDv / 16; ++np) {
            uint32_t bf[4];
            ldmatrix_x4(bf, b_frag_row(skt + np * 16 * kRowB + kk * 32, kRowB, lane));
            MmaBf16::mma(acc[2 * np], pa[kk], bf);
            MmaBf16::mma(acc[2 * np + 1], pa[kk], bf + 2);
          }
      }
    }
  }

#pragma unroll
  for (int nj = 0; nj < kDv / 8; ++nj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* o = out + (row0 + g + 8 * h) * kDv + nj * 8 + 2 * t;
      atomicAdd(o, acc[nj][2 * h]);
      atomicAdd(o + 1, acc[nj][2 * h + 1]);
    }
}

template <bool kInt8>
int launch_attend(const float* iq, const int8_t* iq8, const float* sq, const float* kmat,
                  float* out, int rows, int pairs, int steps, int groups, cudaStream_t st) {
  const int smem = 2 * kKeys * (kKeys * (kInt8 ? 1 : 2) + 16);
  cudaError_t e = cudaFuncSetAttribute(attend_kernel<kInt8>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(rows / kBlockRows, groups);
  attend_kernel<kInt8><<<grid, kThreads, smem, st>>>(iq, iq8, sq, kmat, out, pairs,
                                                     steps / groups);
  return (int)cudaGetLastError();
}

}  // namespace

// iq [rows][128] f32, kmat [>= (2 pairs - 1) * 128][128] f32, out [rows][128]
// f32 zeroed.  int8: iq8 [rows][128] s8 and sq [1] f32 are scratch for the
// quantised iq.  The grid's steps are cut into `groups` runs of blocks.
extern "C" int pcaudio_probe_attend(const void* iq, const void* kmat, void* iq8, void* sq,
                                    void* out, int int8, int rows, int pairs, int steps,
                                    int groups, void* stream) {
  if (rows < kBlockRows || rows % kBlockRows || pairs < 1 || steps < 1 || groups < 1 ||
      steps % groups || ((uintptr_t)iq | (uintptr_t)kmat) % 16)
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  if (!int8)
    return launch_attend<false>((const float*)iq, nullptr, nullptr, (const float*)kmat,
                                (float*)out, rows, pairs, steps, groups, st);
  quant_kernel<<<1, 1024, 0, st>>>((const float*)iq, rows * kDv, (int8_t*)iq8, (float*)sq);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_attend<true>((const float*)iq, (const int8_t*)iq8, (const float*)sq,
                             (const float*)kmat, (float*)out, rows, pairs, steps, groups,
                             st);
}
