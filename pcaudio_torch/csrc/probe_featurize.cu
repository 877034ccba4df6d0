// K3's DFT core on the tensor cores: the H100 counterpart of the TPU probes
// P8 scripts/probe_featurize_blockc.py:78 (`k_unroll`), :93 (`k_stack`) and
// P9 scripts/profile_featurize_variants.py:77 (`k_matmul`), :90
// (`k_matmul_f`), :103 (`k_scratch`), :120 (`k_full`), :143 (`k_nozero`).
//
// Every one computes, per clip b of x3 [B][R][hop] f32 and w0, w1
// [hop][2F] bf16,
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
// What bounds it on the H100: operations, 2 * 2 * B * (R-1) * hop * 2F on
// the bf16 tensor cores (989 TFLOP/s dense).  Device memory sees the f32
// wave once and the bf16 output once; every tile reads its wave rows and
// its W columns from L2.  On the probes' random data the card reaches its
// power limit under this kernel and lowers its SM clock (PERF.md §7).
//
// Design (redesigned for Hopper).  x3 is the contiguous wave viewed as
// [B*R][hop] rows; frame r of clip b is rows b*R + r and b*R + r + 1, so
// the two dots are one product of K = 2 hop whose A rows are overlapping
// windows of the wave.  A block computes 128 frame rows x 128 frequencies:
// 256 product columns, re [f0, f0+128) and im [F+f0, F+f0+128) of W in one
// B tile, so that re and im of one (row, f) land in one thread's
// accumulators (wgmma m64n256: columns c and c + 128 are registers j and
// j + 16 of the same thread) and |.|^2 is formed there.  Three warpgroups:
// warpgroup 0 loads (one thread issues TMA), warpgroups 1 and 2 hold 64
// rows each, 128 f32 accumulators a thread (setmaxnreg moves registers to
// them).  K runs in stages of 32 samples of the hop through a 4-stage ring
// (an mbarrier pair a stage).  One stage is:
//   - the wave: ONE TMA box of 129 rows x 32 f32 (128-byte swizzle), rows
//     m0 .. m0+128, which serves both halves of the frame: half 0 (against
//     w0) reads rows m0 .. m0+127, half 1 (against w1) rows m0+1 .. m0+128.
//     A swizzled bf16 tile cannot be read one row down (the pattern follows
//     row % 8), so the consumers build A in registers (wgmma's RS form):
//     each thread loads its fragments' f32 pairs from the stage at the
//     half's row offset and rounds them to bf16 (cvt.rn, to nearest even),
//     while its previous stage's products run.  Each wave sample leaves L2
//     once per column block; no converted copy is written;
//   - W: w0 and w1 read as they lie ([hop][2F], MN-major B): four boxes of
//     64 columns x 32 rows each (re low, re high, im low, im high), 32 KB.
// L2 bytes a tile and pass, hop 512 (16 stages): wave 16 x 16.5 KB = 264
// KB, W 16 x 32 KB = 512 KB: 776 KB for 67 MFLOP, against 768 KB for 33.5
// MFLOP in the earlier design (128 x 128 tiles, the f32 wave read for both
// halves).  Sums in f32 in the hardware's order within a wgmma, k-steps in
// order.  Work: a unit is one (column block, row tile, group of G clips);
// the blocks are persistent, one an SM, block b running units b, b +
// blocks, ... (column blocks fastest, so that blocks running at once share
// their wave rows in L2), and the loader runs on into the next unit while
// the consumers store.  Rows past a segment's frames are computed and not
// written; the last tile's box reads past the wave's end as zeros (TMA's
// fill).  Within a unit: with per-clip tiles its G clips' tiles run one
// after another; stacked, its tile runs over the G clips' frames as one
// [G R - 1] row space, whose seam rows (a clip's last row paired with the
// next clip's first) are computed and not written.
// ops/kernels/featurize_probes.py::dft_plan is the same plan in Python.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

namespace hw = pcaudio::hopper;

constexpr int kBM = 128;             // frame rows a block
constexpr int kBF = 128;             // frequencies a block (256 product columns)
constexpr int kStageK = 32;          // samples of the hop a stage: one f32 swizzle row
constexpr int kARows = kBM + 1;      // wave rows a stage serves both halves from
constexpr int kABytes = 17 * 1024;   // the wave's 129 rows of 128 bytes, whole atoms
constexpr int kWBox = 64;            // W columns a box (128 bytes of bf16)
constexpr int kWChunk = kStageK * hw::kSwizzleBytes;   // one W box: 4 KB
constexpr int kWHalf = 4 * kWChunk;  // w0's (or w1's) 256 columns of a stage
constexpr int kStageBytes = kABytes + 2 * kWHalf;
constexpr int kStageTx = kARows * kStageK * 4 + 2 * kWHalf;  // bytes TMA lands a stage
constexpr int kStages = 4;
constexpr int kThreads = 384;        // warpgroup 0 loads, 1 and 2 compute
constexpr int kConsumerWarps = 8;
constexpr int kImReg = 4 * (kBF / 8);  // accumulator of im, past its re's
// setmaxnreg's split of the block's 384 x 168 registers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536, "setmaxnreg split");
// Variants that probes/probe_stages.py builds to find what limits the
// kernel (this design: kLeaveOut 0): 1 the copies alone (the consumers
// wait for each stage and free it), 2 the copies and the conversions (no
// products, nothing stored), 3 the copies and the products (A from
// registers never loaded, no conversion; stored), 4 the products alone
// (no copy, no wait: wgmma on whatever the ring holds; stored), 5 the
// products alone, nothing stored.
constexpr int kLeaveOut = 0;
constexpr bool kCopies = kLeaveOut < 4;
constexpr bool kConvert = kLeaveOut == 0 || kLeaveOut == 2;
constexpr bool kProducts = kLeaveOut == 0 || kLeaveOut >= 3;
constexpr bool kStores = kLeaveOut == 0 || kLeaveOut == 3 || kLeaveOut == 4;
constexpr int kSmem = hw::kAtomBytes + kStages * kStageBytes + 2 * kStages * 8;
static_assert(kSmem <= hw::kMaxSmem, "shared memory");
static_assert(kStageBytes % hw::kAtomBytes == 0 && kABytes >= kARows * hw::kSwizzleBytes,
              "stages on swizzle atoms");

enum Mode { kDirect = 0, kShift = 1, kShiftNoZero = 2, kAligned = 3 };

__device__ __forceinline__ int row_shift(int mode, const int* s0, int b) {
  if (mode == kDirect) return 0;
  if (mode == kAligned) return (7 + s0[b]) / 8 * 8 - 8;
  return s0[b] - 1;
}

// f32 pair -> bf16 pair, each rounded to nearest even; lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float mag2(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

struct DftParams {
  const int* s0;
  __nv_bfloat16* out;
  int R, F, rows_out, G, tiles, nk, cols;
  long long units;  // cols x tiles x groups
};

template <int kMode, bool kStacked>
__global__ void __launch_bounds__(kThreads, 1)
dft_mag2_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w0,
                const __grid_constant__ CUtensorMap map_w1, const DftParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((hw::kAtomBytes - (hw::smem_u32(smem_raw) & (hw::kAtomBytes - 1))) &
                              (hw::kAtomBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int R = p.R;
  const int passes = kStacked ? 1 : p.G;
  const int seg_rows = kStacked ? p.G * R - 1 : R - 1;  // product rows of a segment
  // unit u: column block u % cols, row tile (u / cols) % tiles, group of G
  // clips u / (cols tiles)
  auto column = [&](long long u) { return (int)(u % p.cols) * kBF; };
  auto tile = [&](long long u) { return (int)((u / p.cols) % p.tiles); };
  auto group = [&](long long u) { return (int)(u / ((long long)p.cols * p.tiles)); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hw::mbar_init(&full[i], 1);
      hw::mbar_init(&empty[i], kConsumerWarps);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  const int wg = hw::warpgroup();
  if (wg == 0) {  // ---- the loader: one thread issues every copy -----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && kCopies) {
      int stage = 0;
      unsigned phase = 0;
      for (long long unit = blockIdx.x; unit < p.units; unit += gridDim.x) {
        const int f0 = column(unit);
        for (int pass = 0; pass < passes; ++pass) {
          // the tile's first wave row: clip group * G + pass's, or the group's
          const int row0 = (group(unit) * p.G + (kStacked ? 0 : pass)) * R + tile(unit) * kBM;
          for (int kt = 0; kt < p.nk; ++kt) {
            hw::mbar_wait(&empty[stage], phase ^ 1);
            hw::mbar_expect_tx(&full[stage], kStageTx);
            uint8_t* st = ring + stage * kStageBytes;
            hw::tma_load_3d(st, &map_x, kt * kStageK, row0, 0, &full[stage]);
            // box i: half i / 4 (w0, w1), columns re low, re high, im low, im high
            for (int i = 0; i < 8; ++i) {
              const int half = i / 4, chunk = i % 4;
              const int col = (chunk < 2 ? f0 : p.F + f0) + (chunk % 2) * kWBox;
              uint8_t* dst = st + kABytes + half * kWHalf + chunk * kWChunk;
              const CUtensorMap* map = half ? &map_w1 : &map_w0;
              hw::tma_load_3d(dst, map, col, kt * kStageK, 0, &full[stage]);
            }
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {  // ---- warpgroups 1 and 2: 64 frame rows each --------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, q = lane % 4;
    const int lrow = cw * 64 + warp * 16 + g;  // this thread's first row in the tile
    const uint32_t ring_u = hw::smem_u32(ring);
    float acc[128];
    uint32_t fa[2][4][4] = {};  // A fragments of a stage: [k-step: half 2 + ks][reg]
    int stage = 0;
    unsigned phase = 0;

    auto release = [&](int s) {  // this warp is done with stage s
      hw::fence_proxy_async();   // its reads, before the copies that refill it
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(&empty[s]);
    };
    // A fragments of half h, k-step ks: rows lrow + h (+8), samples
    // 16 ks + 2q, +1 (regs 0, 1) and 16 ks + 8 + 2q, +1 (regs 2, 3)
    auto load_a = [&](uint32_t (&a)[4][4], const uint8_t* sa) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i / 2, ks = i % 2;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = lrow + h + 8 * (r & 1);
          const int col = (16 * ks + 8 * (r >> 1) + 2 * q) * 4;  // bytes
          const float2 v = *reinterpret_cast<const float2*>(sa + hw::swizzle128(row, col));
          a[i][r] = bf16x2(v.x, v.y);
        }
      }
    };

    for (long long unit = blockIdx.x; unit < p.units; unit += gridDim.x)
    for (int pass = 0; pass < passes; ++pass) {
      const int f0 = column(unit), by = tile(unit), m0 = by * kBM;
      const int clip0 = group(unit) * p.G + (kStacked ? 0 : pass);  // the segment's first clip
      if constexpr (kMode == kShift) {
        // the first row tile zeroes the output rows whose source frame lies
        // before the clip, the last tile those after its R - 1 frames
        const int shift = row_shift(kMode, p.s0, clip0);
        const int t = threadIdx.x - 128;
        auto zero = [&](int j0, int j1) {
          for (int i = t; i < (j1 - j0) * (kBF / 2); i += 256) {
            const int j = j0 + i / (kBF / 2), f = f0 + 2 * (i % (kBF / 2));
            *reinterpret_cast<uint32_t*>(p.out + ((long long)clip0 * p.rows_out + j) * p.F +
                                         f) = 0u;
          }
        };
        if (by == 0) zero(0, max(0, min(p.rows_out, -shift)));
        if (by == p.tiles - 1) zero(max(0, R - 1 - shift), p.rows_out);
      }
      int held = -1;
      for (int kt2 = 0; kt2 < p.nk; kt2 += 2) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {  // fa[u] is read by this stage's products
          const int kt = kt2 + u;
          if constexpr (kCopies) hw::mbar_wait(&full[stage], phase);
          const uint8_t* sa = ring + stage * kStageBytes;
          if constexpr (kConvert) load_a(fa[u], sa);
          if constexpr (kLeaveOut == 2) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int r = 0; r < 4; ++r) asm volatile("" ::"r"(fa[u][i][r]));
          }
          if constexpr (kProducts) {
            const uint32_t wb = ring_u + stage * kStageBytes + kABytes;
            hw::wgmma_fence();
            hw::fence_operand(acc);
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // half i / 2 against w0 / w1, k-step i % 2
              const uint64_t db = hw::smem_desc(wb + (i / 2) * kWHalf + (i % 2) * 16 *
                                                hw::kSwizzleBytes, kWChunk, hw::kSbo);
              hw::wgmma_bf16_rs_n256<1>(acc, fa[u][i], db, (kt | i) ? 1u : 0u);
            }
            hw::wgmma_commit();
            hw::wgmma_wait<1>();  // the stage before this one is read
            hw::fence_operand(acc);
          }
          if (kCopies && held >= 0) release(held);
          held = stage;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      hw::wgmma_wait<0>();
      hw::fence_operand(acc);
      if constexpr (kCopies) release(held);
      if constexpr (!kProducts) continue;
      if constexpr (!kStores) {  // the sums kept live by a store no call takes
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < 128; ++i) t += acc[i];
        if (p.rows_out < 0) reinterpret_cast<float*>(p.out)[threadIdx.x] = t;
        continue;
      }

      // epilogue: |.|^2 in registers, each frame row to its output row.  A
      // thread's word jj holds frequencies f0 + 8 jj + 2q, +1; lanes q and
      // q ^ 1 (one row) trade a word so that each stores 8 bytes: even q
      // frequencies 8 jj + 2q .. +3, odd q 8 (jj + 1) + 2q - 2 .. +3, and
      // each store instruction fills whole 32-byte sectors.
      const bool odd = q & 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = m0 + lrow + 8 * h;  // the row in the segment
        const int c = kStacked ? s / R : 0;
        const int r = s - c * R;
        const int b = clip0 + c;
        // past the segment or a stacked seam row: not written
        bool ok = s < seg_rows && r < R - 1;
        const int j = ok ? r - row_shift(kMode, p.s0, b) : -1;
        ok = ok && j >= 0 && j < p.rows_out;
        __nv_bfloat16* o = p.out + ((long long)b * p.rows_out + j) * p.F + f0 + 2 * (q & 2);
#pragma unroll
        for (int jj = 0; jj < kBF / 8; jj += 2) {
          uint32_t w[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * (jj + e) + 2 * h;
            w[e] = bf16x2(mag2(acc[i], acc[kImReg + i]), mag2(acc[i + 1], acc[kImReg + i + 1]));
          }
          const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? w[0] : w[1], 1);
          if (ok)
            *reinterpret_cast<uint2*>(o + 8 * (jj + odd)) =
                odd ? make_uint2(got, w[1]) : make_uint2(w[0], got);
        }
      }
    }
  }
}

template <int kMode, bool kStacked>
int launch(const CUtensorMap& mx, const CUtensorMap& m0, const CUtensorMap& m1,
           const DftParams& p, int blocks, cudaStream_t stream) {
  static bool sized = false;  // ask once for the dynamic shared memory
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(dft_mag2_kernel<kMode, kStacked>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  dft_mag2_kernel<kMode, kStacked><<<blocks, kThreads, kSmem, stream>>>(mx, m0, m1, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x3 [B][R][hop] f32, w0 and w1 [hop][2F] bf16, s0 [B] int32 (modes 1-3;
// may be null in mode 0), out [B][rows_out][F] bf16.  hop a multiple of
// 64, F of 128, B of G; stacked in mode 0 only; 16-byte aligned pointers;
// `blocks` persistent blocks (ops/kernels/featurize_probes.py::dft_plan:
// one an SM, at most one a unit).
extern "C" int pcaudio_probe_dft_mag2(const void* x, const void* w0, const void* w1,
                                      const void* s0, void* out, int B, int R, int hop, int F,
                                      int rows_out, int G, int stacked, int mode, int blocks,
                                      void* stream) {
  if (B < 1 || R < 2 || hop < 2 * kStageK || hop % (2 * kStageK) || F < kBF || F % kBF ||
      rows_out < 1 || G < 1 || B % G || mode < kDirect || mode > kAligned ||
      (mode != kDirect && !s0) || (stacked && mode != kDirect) ||
      (mode == kDirect && rows_out > R - 1) || (long long)B * R > (1LL << 31) - 1 ||
      blocks < 1 ||
      ((uintptr_t)x | (uintptr_t)w0 | (uintptr_t)w1 | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  const int seg_rows = stacked ? G * R - 1 : R - 1;
  const int tiles = (seg_rows + kBM - 1) / kBM;
  CUtensorMap mx, mw0, mw1;
  const cuuint64_t x_dims[3] = {(cuuint64_t)hop, (cuuint64_t)B * R, 1};
  const cuuint64_t x_strides[2] = {(cuuint64_t)hop * 4, (cuuint64_t)B * R * hop * 4};
  const cuuint32_t x_box[3] = {kStageK, kARows, 1};
  const cuuint64_t w_dims[3] = {(cuuint64_t)2 * F, (cuuint64_t)hop, 1};
  const cuuint64_t w_strides[2] = {(cuuint64_t)2 * F * 2, (cuuint64_t)hop * 2 * F * 2};
  const cuuint32_t w_box[3] = {kWBox, kStageK, 1};
  if (!hw::tensor_map_3d(&mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, x_dims, x_strides, x_box) ||
      !hw::tensor_map_3d(&mw0, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w0, w_dims, w_strides, w_box) ||
      !hw::tensor_map_3d(&mw1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w1, w_dims, w_strides, w_box))
    return (int)cudaErrorInvalidValue;
  DftParams p{};
  p.s0 = static_cast<const int*>(s0);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.R = R;
  p.F = F;
  p.rows_out = rows_out;
  p.G = G;
  p.tiles = tiles;
  p.nk = hop / kStageK;
  p.cols = F / kBF;
  p.units = (long long)p.cols * tiles * (B / G);
  blocks = (int)(blocks < p.units ? blocks : p.units);
  const auto st = (cudaStream_t)stream;
  if (stacked) return launch<kDirect, true>(mx, mw0, mw1, p, blocks, st);
  switch (mode) {
    case kDirect: return launch<kDirect, false>(mx, mw0, mw1, p, blocks, st);
    case kShift: return launch<kShift, false>(mx, mw0, mw1, p, blocks, st);
    case kShiftNoZero: return launch<kShiftNoZero, false>(mx, mw0, mw1, p, blocks, st);
    default: return launch<kAligned, false>(mx, mw0, mw1, p, blocks, st);
  }
}
