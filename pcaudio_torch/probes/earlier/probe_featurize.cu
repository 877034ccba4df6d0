// K3's DFT core on the tensor cores: the H100 counterpart of the TPU probes
// P8 scripts/probe_featurize_blockc.py:78 (`k_unroll`), :93 (`k_stack`) and
// P9 scripts/profile_featurize_variants.py:77 (`k_matmul`), :90
// (`k_matmul_f`), :103 (`k_scratch`), :120 (`k_full`), :143 (`k_nozero`).
//
// Every one computes, per clip b of x3 [B][R][hop] f32 and W = [w0; w1]
// [2 hop][2F] bf16,
//   reim = x[:R-1] . w0 + x[1:] . w1   (bf16 operands, f32 sums)
//   m2   = reim[:, :F]^2 + reim[:, F:]^2
// and writes m2's frames into out [B][C*Nt][F] bf16, output row j from
// source frame j + shift(b):
//   kDirect       shift 0                          (k_matmul, k_matmul_f,
//                                                   k_unroll, k_stack)
//   kShift        s0 - 1, rows with no source 0    (k_full)
//   kShiftNoZero  s0 - 1, those rows unwritten     (k_nozero)
//   kAligned      8 floor((7 + s0) / 8) - 8,       (k_scratch)
//                 rows with no source unwritten.
// The TPU kernels stage m2 in a VMEM scratch of R + C*Nt + 24 rows (1.8 MB)
// to shift it; here the shift is a per-clip row offset in the epilogue and
// m2 never leaves registers.
//
// One product a clip: x3 is the contiguous wave viewed as [R][hop], so frame
// r = [x[r], x[r+1]] is the 2 hop samples at r * hop, and the two dots are
// one [R-1][2 hop] . [2 hop][2F] product whose A rows are overlapping
// windows of the wave (no copy).  W arrives transposed, Wt [2F][2 hop].
//
// What bounds it on the H100: operations, 2 * 2 * B * (R-1) * hop * 2F on
// the bf16 tensor cores (989 TFLOP/s dense through wgmma; mma.sync, used
// here, reached 227 TFLOP/s in probe_mma.cu's GEMM).  Device memory sees
// the f32 wave once (the eight frequency blocks of one row tile run side
// by side and share it through L2) and the bf16 output once.
//
// Design: a block computes a 128-row x 64-frequency tile, which is 128
// columns of the product: re columns [f0, f0+64) and im columns
// [F+f0, F+f0+64), so that re and im of one (row, f) land in the same
// thread's accumulators and |.|^2 is formed there.  8 warps of 64 rows x
// (16 re + 16 im) columns, mma.sync m16n8k16 bf16 -> f32, fragments by
// ldmatrix.  K in 32-value stages through a two-stage ring in padded shared
// memory: Wt by cp.async, the wave by 16-byte f32 loads into registers one
// stage ahead, rounded to bf16 (round to nearest even) on the way to shared
// memory (cp.async cannot convert).  Rows beyond a clip's R-1 frames are
// zero and not written.  G clips go to one block: with per-clip tiles the
// block runs its G clips' tiles one after another; stacked, its tiles run
// over the G clips' frames as one [G R - 1] row space, whose seam rows (a
// clip's last row paired with the next clip's first) are computed and not
// written.  W's tiles are re-read from L2 (2 MB) by every tile: a block's
// 128 columns over all of K are 256 KB, more than shared memory holds.
#include "mma.cuh"

namespace {

using namespace pcaudio;

constexpr int kBM = 128;            // frame rows a block
constexpr int kBF = 64;             // frequencies a block (128 product columns)
constexpr int kStageK = 32;         // bf16 values of K a stage
constexpr int kRow = kStageK * 2 + 16;  // padded shared-memory row, bytes
constexpr int kThreads = 256;
constexpr int kAVecs = kBM * kStageK / 4 / kThreads;  // float4 loads a thread a stage

enum Mode { kDirect = 0, kShift = 1, kShiftNoZero = 2, kAligned = 3 };

__device__ __forceinline__ int row_shift(int mode, const int* s0, int b) {
  if (mode == kDirect) return 0;
  if (mode == kAligned) return (7 + s0[b]) / 8 * 8 - 8;
  return s0[b] - 1;
}

template <int kMode, bool kStacked>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM: <= 128 registers
dft_mag2_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wt,
                const int* __restrict__ s0, __nv_bfloat16* __restrict__ out, int R, int hop,
                int F, int rows_out, int G, int tiles) {
  __shared__ __align__(16) uint8_t sA[2][kBM * kRow];
  __shared__ __align__(16) uint8_t sB[2][2 * kBF * kRow];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 rows x (16 + 16)
  const int f0 = blockIdx.x * kBF;
  const int m0 = blockIdx.y * kBM;
  const int group = blockIdx.z;
  const int K = 2 * hop, kbytes = K * 2, nk = K / kStageK;
  const int n_rows = kStacked ? G * R - 1 : R - 1;  // product rows of one pass
  const float* xg = x + (long long)group * G * R * hop;

  for (int pass = 0; pass < (kStacked ? 1 : G); ++pass) {
    const float* xa = xg + (long long)pass * R * hop;  // the pass's first frame
    float4 ra[kAVecs];
    auto load_a = [&](int kt) {  // global f32 -> registers
#pragma unroll
      for (int u = 0; u < kAVecs; ++u) {
        const int i = threadIdx.x + u * kThreads;
        const int row = i >> 3, c4 = i & 7;
        ra[u] = m0 + row < n_rows
                    ? *reinterpret_cast<const float4*>(xa + (long long)(m0 + row) * hop +
                                                       kt * kStageK + c4 * 4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    auto store_a = [&](int stage) {  // registers -> bf16 shared memory
#pragma unroll
      for (int u = 0; u < kAVecs; ++u) {
        const int i = threadIdx.x + u * kThreads;
        const int row = i >> 3, c4 = i & 7;
        uint2 v;
        v.x = pack_bf16(ra[u].x, ra[u].y);
        v.y = pack_bf16(ra[u].z, ra[u].w);
        *reinterpret_cast<uint2*>(&sA[stage][row * kRow + c4 * 8]) = v;
      }
    };
    auto load_b = [&](int kt, int stage) {  // Wt rows: 64 re, then 64 im
      for (int i = threadIdx.x; i < 2 * kBF * 4; i += kThreads) {
        const int row = i >> 2, c = (i & 3) * 16;
        const int wrow = row < kBF ? f0 + row : F + f0 + row - kBF;
        cp_async16(&sB[stage][row * kRow + c],
                   wt + (long long)wrow * kbytes + kt * kStageK * 2 + c);
      }
      cp_async_commit();
    };

    // kShift: the first row tile zeroes the output rows whose source frame
    // lies before the clip, the last tile those after its R - 1 frames
    // (before the product, while no accumulator is live)
    const bool first = blockIdx.y == 0, last = blockIdx.y == tiles - 1;
    if (kMode == kShift && (first || last)) {
      const int b = group * G + pass;
      const int shift = row_shift(kMode, s0, b);
      for (int i = threadIdx.x; i < rows_out * (kBF / 2); i += kThreads) {
        const int j = i / (kBF / 2), f = f0 + (i % (kBF / 2)) * 2;
        if ((first && j + shift < 0) || (last && j + shift > R - 2))
          *reinterpret_cast<uint32_t*>(out + ((long long)b * rows_out + j) * F + f) = 0u;
      }
    }
    float acc[4][4][4] = {};  // [m tile][re 0-1, im 2-3][C regs]
    load_a(0);
    load_b(0, 0);
    store_a(0);
    cp_async_wait<0>();
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt & 1;
      if (kt + 1 < nk) {
        load_a(kt + 1);
        load_b(kt + 1, st ^ 1);
      }
      const uint8_t* ta = sA[st] + (wm * 64) * kRow;
      const uint8_t* tre = sB[st] + (wn * 16) * kRow;
      const uint8_t* tim = sB[st] + (kBF + wn * 16) * kRow;
#pragma unroll
      for (int ks = 0; ks < kStageK / 16; ++ks) {
        uint32_t af[4][4], bre[4], bim[4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(af[mi], a_frag_row(ta + mi * 16 * kRow + ks * 32, kRow, lane));
        ldmatrix_x4(bre, b_frag_row(tre + ks * 32, kRow, lane));
        ldmatrix_x4(bim, b_frag_row(tim + ks * 32, kRow, lane));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          MmaBf16::mma(acc[mi][0], af[mi], bre);
          MmaBf16::mma(acc[mi][1], af[mi], bre + 2);
          MmaBf16::mma(acc[mi][2], af[mi], bim);
          MmaBf16::mma(acc[mi][3], af[mi], bim + 2);
        }
      }
      if (kt + 1 < nk) {
        store_a(st ^ 1);  // stage st ^ 1 was last read before the previous sync
        cp_async_wait<0>();
      }
      __syncthreads();
    }

    // epilogue: |.|^2 in registers, each frame row to its output row
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = m0 + wm * 64 + mi * 16 + g + 8 * h;
        if (s >= n_rows) continue;
        const int clip = kStacked ? s / R : pass;
        const int r = kStacked ? s - clip * R : s;
        if (r >= R - 1) continue;  // a stacked seam row
        const int b = group * G + clip;
        const int j = r - row_shift(kMode, s0, b);
        if (j < 0 || j >= rows_out) continue;
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const float re0 = acc[mi][nj][2 * h], re1 = acc[mi][nj][2 * h + 1];
          const float im0 = acc[mi][nj + 2][2 * h], im1 = acc[mi][nj + 2][2 * h + 1];
          const float v0 = __fadd_rn(__fmul_rn(re0, re0), __fmul_rn(im0, im0));
          const float v1 = __fadd_rn(__fmul_rn(re1, re1), __fmul_rn(im1, im1));
          const int f = f0 + wn * 16 + nj * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(out + ((long long)b * rows_out + j) * F + f) =
              pack_bf16(v0, v1);
        }
      }
  }
}

template <int kMode, bool kStacked>
int launch(const void* x, const void* wt, const void* s0, void* out, int B, int R, int hop,
           int F, int rows_out, int G, cudaStream_t stream) {
  const int rows = kStacked ? G * R - 1 : R - 1;
  const int tiles = (rows + kBM - 1) / kBM;
  const dim3 grid(F / kBF, tiles, B / G);
  dft_mag2_kernel<kMode, kStacked><<<grid, kThreads, 0, stream>>>(
      (const float*)x, (const uint8_t*)wt, (const int*)s0, (__nv_bfloat16*)out, R, hop, F,
      rows_out, G, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x3 [B][R][hop] f32, wt = [w0; w1]^T [2F][2 hop] bf16, s0 [B] int32 (modes
// 1-3; may be null in mode 0), out [B][rows_out][F] bf16.  hop a multiple of
// 16, F of 64, B of G; stacked in mode 0 only; 16-byte aligned pointers.
extern "C" int pcaudio_probe_dft_mag2(const void* x, const void* wt, const void* s0, void* out,
                                      int B, int R, int hop, int F, int rows_out, int G,
                                      int stacked, int mode, void* stream) {
  if (B < 1 || R < 2 || hop < 16 || hop % 16 || F < kBF || F % kBF || rows_out < 1 ||
      G < 1 || B % G || mode < kDirect || mode > kAligned || (mode != kDirect && !s0) ||
      (stacked && mode != kDirect) || (mode == kDirect && rows_out > R - 1) ||
      ((uintptr_t)x | (uintptr_t)wt | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  if (stacked) return launch<kDirect, true>(x, wt, s0, out, B, R, hop, F, rows_out, G, st);
  switch (mode) {
    case kDirect: return launch<kDirect, false>(x, wt, s0, out, B, R, hop, F, rows_out, G, st);
    case kShift: return launch<kShift, false>(x, wt, s0, out, B, R, hop, F, rows_out, G, st);
    case kShiftNoZero:
      return launch<kShiftNoZero, false>(x, wt, s0, out, B, R, hop, F, rows_out, G, st);
    default: return launch<kAligned, false>(x, wt, s0, out, B, R, hop, F, rows_out, G, st);
  }
}
