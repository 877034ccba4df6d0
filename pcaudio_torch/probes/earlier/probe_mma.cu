// The mma.sync design of csrc/probe_mma.cu before its wgmma redesign (git 1bc6fde),
// kept verbatim below so that probes/probe_stages.py and chip_smoke.py phase 8 can
// build it as its own library and time it beside the redesign in one process.
// Probe kernels on the tensor cores (mma.sync) and the special-function
// units: the H100 counterparts of the TPU timing probes behind K1's design
// questions.
//
//   window_gemm_kernel  P1 scripts/probe_batched_dot.py:9 (`kernel`) and P2
//                       scripts/probe_int8_matmul.py:21 (`kern`), :44
//                       (`make_big`), :85 (`make`):
//                       out[b] = sum_{i<reps} A[b][i*shift : i*shift+M] . B[b],
//                       bf16 -> f32 or s8 -> s32;
//   chain_kernel        P4a scripts/probe_lane_width.py:28 (`chain_kernel`):
//                       x <- bf16(x . w), reps times, [n, D] . [D, D];
//   exp_chain_kernel    P4b scripts/probe_lane_width.py:65 (`vpu_kernel`):
//                       x <- exp(0.5 x), reps times, f32.
//
// The TPU probes ran a grid of 256 identical steps in order on one core.
// Here the repeats run as independent blocks; every repeat's result is
// added into the output (atomics; a block first sums `per` repeats in
// registers), so the output depends on every repeat's work:
//   - s32 sums are exact in any order;
//   - the chain's output is `repeats` copies of one bf16 value per
//     element: every partial sum k.v (k <= 256, v with 8 significant bits)
//     is exact in f32, so the order does not matter;
//   - the bf16 GEMM of the script's integer operands in [-4, 4) sums
//     integers, exact while every partial sum stays below 2^24;
//   - the exp chain overflows to +inf on the script's inputs (exp(x/2) > x
//     for every x), where order does not matter either.
//
// What bounds them on the H100: operations, on the tensor cores for the
// GEMMs (989 TFLOP/s bf16, 1,979 TOP/s s8 dense, through wgmma; mma.sync,
// used here, reaches a fraction of that) and on the MUFU.EX2 units for the
// exp chain (16 a clock per SM).  The operands are re-read from L2 by
// every block; device memory sees each input once.
//
// Design: 128 x 128 output tiles, 8 warps of 64 x 32, K in 64-byte stages
// through a two-stage cp.async ring in padded shared memory (80-byte rows:
// ldmatrix without bank conflicts), fragments by ldmatrix.  B arrives
// transposed ([N, K], K contiguous), so one loader serves bf16 and s8 (s8
// has no ldmatrix.trans).  The chain keeps a 16-row slice of x in each
// warp's registers through all its products: an m16n8 accumulator tile is
// the next product's A fragment after a bf16 pack.
#include "mma.cuh"

namespace {

using namespace pcaudio;

constexpr int kBM = 128, kBN = 128;
constexpr int kStageBytes = 64;           // bytes of K per pipeline stage
constexpr int kRow = kStageBytes + 16;    // padded shared-memory row
constexpr int kGemmThreads = 256;

template <class Mma>
__global__ void __launch_bounds__(kGemmThreads)
window_gemm_kernel(const uint8_t* __restrict__ A, long long a_batch,
                   const uint8_t* __restrict__ Bt, long long b_batch,
                   typename Mma::Acc* __restrict__ out, long long out_batch, int N,
                   int kbytes, int reps, int shift, int batch, int per) {
  using Acc = typename Mma::Acc;
  __shared__ __align__(16) uint8_t sA[2][kBM * kRow];
  __shared__ __align__(16) uint8_t sB[2][kBN * kRow];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int b0 = blockIdx.z * per;
  const int nb = min(per, batch - b0);
  const int nk = kbytes / kStageBytes;
  const int total = nb * reps * nk;

  auto load = [&](int it, int stage) {
    const int kt = it % nk, r = (it / nk) % reps, b = b0 + it / (nk * reps);
    const uint8_t* a = A + b * a_batch + (long long)(r * shift + m0) * kbytes + kt * kStageBytes;
    const uint8_t* bt = Bt + b * b_batch + (long long)n0 * kbytes + kt * kStageBytes;
    for (int i = threadIdx.x; i < kBM * 4; i += kGemmThreads) {
      const int row = i >> 2, c = (i & 3) * 16;
      cp_async16(&sA[stage][row * kRow + c], a + (long long)row * kbytes + c);
      cp_async16(&sB[stage][row * kRow + c], bt + (long long)row * kbytes + c);
    }
    cp_async_commit();
  };

  Acc acc[4][4][4] = {};
  load(0, 0);
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {
      load(it + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* ta = sA[it & 1] + (wm * 64) * kRow;
    const uint8_t* tb = sB[it & 1] + (wn * 32) * kRow;
#pragma unroll
    for (int ks = 0; ks < kStageBytes / 32; ++ks) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], a_frag_row(ta + mi * 16 * kRow + ks * 32, kRow, lane));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(bf[np], b_frag_row(tb + np * 16 * kRow + ks * 32, kRow, lane));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          Mma::mma(acc[mi][nj], af[mi], &bf[nj >> 1][(nj & 1) * 2]);
    }
    __syncthreads();  // the next load refills this stage
  }

  const int g = lane >> 2, t = lane & 3;
  Acc* o = out + (out_batch ? b0 * out_batch : 0);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + g + 8 * h;
        const int col = n0 + wn * 32 + nj * 8 + 2 * t;
        Acc* p = o + (long long)row * N + col;
        if (out_batch) {
          p[0] = acc[mi][nj][2 * h];
          p[1] = acc[mi][nj][2 * h + 1];
        } else {
          atomicAdd(p, acc[mi][nj][2 * h]);
          atomicAdd(p + 1, acc[mi][nj][2 * h + 1]);
        }
      }
}

constexpr int kChainThreads = 128;  // 4 warps, 16 rows each

template <int D>
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
             float* __restrict__ out, int reps, int per) {
  constexpr int kRowW = D * 2 + 16;  // padded bytes per row of w^T
  __shared__ __align__(16) uint8_t sw[D * kRowW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int i = threadIdx.x; i < D * D / 8; i += kChainThreads) {
    const int row = i / (D / 8), c = (i % (D / 8)) * 16;
    *reinterpret_cast<uint4*>(&sw[row * kRowW + c]) =
        *reinterpret_cast<const uint4*>(reinterpret_cast<const uint8_t*>(wt) + row * D * 2 + c);
  }
  __syncthreads();

  const int r0 = blockIdx.x * 64 + warp * 16;
  float sum[D / 8][4] = {};
  for (int rep = 0; rep < per; ++rep) {
    uint32_t xa[D / 16][4];  // this warp's 16 rows of x as A fragments
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = r0 + g + 8 * (q & 1), col = kk * 16 + 8 * (q >> 1) + 2 * t;
        xa[kk][q] = *reinterpret_cast<const uint32_t*>(x + (long long)row * D + col);
      }
    for (int s = 0; s < reps; ++s) {
      float c[D / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, b_frag_row(sw + np * 16 * kRowW + kk * 32, kRowW, lane));
          MmaBf16::mma(c[2 * np], xa[kk], bf);
          MmaBf16::mma(c[2 * np + 1], xa[kk], bf + 2);
        }
      // the product's columns 16kk..16kk+15 are the next A's k-step kk
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        xa[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
        xa[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
        xa[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
        xa[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = unpack_bf16(xa[kk][q]);
        // A reg q: rows g / g+8 (q & 1), columns 8 (q >> 1) + 2t of step kk,
        // i.e. n-tile 2kk + (q >> 1), C regs 2 (q & 1), +1
        float* s2 = &sum[2 * kk + (q >> 1)][2 * (q & 1)];
        s2[0] += v.x;
        s2[1] += v.y;
      }
  }
#pragma unroll
  for (int nj = 0; nj < D / 8; ++nj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = out + (long long)(r0 + g + 8 * h) * D + nj * 8 + 2 * t;
      atomicAdd(p, sum[nj][2 * h]);
      atomicAdd(p + 1, sum[nj][2 * h + 1]);
    }
}

__global__ void exp_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                                 int n, int reps, int per) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int r = 0; r < per; ++r) {
    float v = x[i];
    asm volatile("" : "+f"(v));  // each repeat recomputes the chain
    for (int s = 0; s < reps; ++s) v = __expf(v * 0.5f);
    acc += v;
  }
  atomicAdd(out + i, acc);
}

template <int D>
int launch_chain(const void* x, const void* wt, float* out, int n, int reps, int repeats,
                 int per, cudaStream_t stream) {
  const dim3 grid(n / 64, repeats / per);
  chain_kernel<D><<<grid, kChainThreads, 0, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wt, out, reps, per);
  return (int)cudaGetLastError();
}

}  // namespace

// A [batch][rows][K] (rows >= M + (reps-1) shift), Bt [batch][N][K], both
// bf16 (int8 == 0) or s8, batch strides in bytes (0: every batch reads the
// same matrix).  out f32 or s32 [batch][M][N] with out_batch elements
// between batches, or out_batch == 0: every batch's product is added into
// one zeroed [M][N].  per batches go to one block (out_batch == 0 only).
extern "C" int pcaudio_probe_matmul(const void* a, long long a_batch, const void* bt,
                                    long long b_batch, void* out, long long out_batch,
                                    int int8, int M, int N, int K, int reps, int shift,
                                    int batch, int per, void* stream) {
  const int kbytes = K * (int8 ? 1 : 2);
  if (M < kBM || N < kBN || M % kBM || N % kBN || kbytes % kStageBytes || reps < 1 ||
      shift < 0 || batch < 1 || per < 1 || (out_batch && per != 1) ||
      a_batch % 16 || b_batch % 16 || ((uintptr_t)a | (uintptr_t)bt) % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kBN, M / kBM, (batch + per - 1) / per);
  const auto st = (cudaStream_t)stream;
  if (int8)
    window_gemm_kernel<MmaS8><<<grid, kGemmThreads, 0, st>>>(
        (const uint8_t*)a, a_batch, (const uint8_t*)bt, b_batch, (int*)out, out_batch, N,
        kbytes, reps, shift, batch, per);
  else
    window_gemm_kernel<MmaBf16><<<grid, kGemmThreads, 0, st>>>(
        (const uint8_t*)a, a_batch, (const uint8_t*)bt, b_batch, (float*)out, out_batch, N,
        kbytes, reps, shift, batch, per);
  return (int)cudaGetLastError();
}

// x [n][d] bf16, wt = w^T [d][d] bf16, out [n][d] f32 zeroed: out += the
// chain's result once per repeat.  d 64 or 128, n a multiple of 64.
extern "C" int pcaudio_probe_chain(const void* x, const void* wt, void* out, int n, int d,
                                   int reps, int repeats, int per, void* stream) {
  if (n < 64 || n % 64 || reps < 1 || repeats < 1 || per < 1 || repeats % per ||
      ((uintptr_t)x | (uintptr_t)wt) % 16)
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  if (d == 64) return launch_chain<64>(x, wt, (float*)out, n, reps, repeats, per, st);
  if (d == 128) return launch_chain<128>(x, wt, (float*)out, n, reps, repeats, per, st);
  return (int)cudaErrorInvalidValue;
}

// x [n] f32, out [n] f32 zeroed: out += the exp chain once per repeat.
extern "C" int pcaudio_probe_exp_chain(const void* x, void* out, int n, int reps,
                                       int repeats, int per, void* stream) {
  if (n < 1 || reps < 1 || repeats < 1 || per < 1 || repeats % per)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + 255) / 256, repeats / per);
  exp_chain_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out, n,
                                                           reps, per);
  return (int)cudaGetLastError();
}
