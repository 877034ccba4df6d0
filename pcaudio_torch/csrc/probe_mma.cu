// Probe kernels on the tensor cores and the special-function units: the
// H100 counterparts of the TPU timing probes behind K1's design questions.
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
// Here the repeats run as independent work; every repeat's result is added
// into the output (a block sums its units in registers, then adds them with
// atomics), so the output depends on every repeat's work:
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
// GEMMs (989 TFLOP/s bf16, 1,979 TOP/s s8 dense) and on the MUFU.EX2 units
// for the exp chain (16 a clock per SM).  Device memory sees each input once.
//
// The GEMM (redesigned for Hopper): wgmma m64n128k16 (bf16) and m64n128k32
// (s8) with f32 / s32 sums in registers.  A block is one producer warpgroup
// (one thread issues TMA) and two consumer warpgroups of 64 output rows
// each: a 128 x 128 tile.  It keeps its B panel ([K, 128]) resident in
// shared memory for its whole life: bf16 through TMA as it lies ([K, N],
// N contiguous: wgmma's MN-major B, so no transposed copy); s8, whose wgmma
// takes only K-major B, transposed by the block's threads once while they
// stage it (no extra launch).  A streams through a ring of `stages` slabs
// (TMA 3-D tiles, 128-byte swizzle, an mbarrier pair a stage): a slab is
// 128 + (G - 1) * shift rows of 128 bytes of K, and window i of its group
// is the descriptor moved down i * shift rows, so every window's product is
// issued from one load (as the TPU script slices its windows out of one
// VMEM block).  Work: panels = batch x N / 128 tiles' columns; each panel's
// units (m-tile, repeat, window group), in that order, are cut into
// `blocks` contiguous runs, one a block, so that panels x blocks fill the
// SMs in one wave (132 = 4 x 33 at P2b).  A block adds its sum into the
// output when its run leaves an m-tile and at its end; where every tile is
// one unit (P1, P2a) it stores instead.  Sum order (f32): within a block,
// units in order, windows in order, K in order (each wgmma's own k order
// is the hardware's); across a tile's blocks, atomics in arrival order.
// ops/kernels/probes.py::matmul_plan is the same plan in Python.
//
// The chain (redesigned for Hopper): a dependent product cannot be split
// along K or batched with the next, so the design keeps enough independent
// chains in flight on each SM.  A block is one warpgroup, one chain of 64
// rows of x at a time, held in registers as wgmma A fragments through all
// its products (m64n128k16 at d 128, m64n64k16 at d 64, A from registers):
// columns 16kk .. 16kk + 15 of a step's f32 accumulators are, after a
// bf16 pack, the next step's A fragment for k-step kk, so no operand of x
// touches shared memory.  Each step's first product starts its sums with
// scale-d 0 (no write of the accumulators between wgmmas).  w stays
// resident in shared memory as it lies ([K, N], N contiguous: MN-major B,
// 128-byte swizzle, the second 64 columns LBO bytes on), loaded once a
// block by TMA, so the wrapper makes no transposed copy.  Between two steps
// a warpgroup waits for its products, packs and fences: 2 blocks an SM at
// d 128 (a step's 8 products take about 512 tensor-core clocks, more than
// the turnaround) and 4 at d 64 (128 clocks), so that one block's products
// run while another packs.  The blocks walk units (row tile, repeat) in
// contiguous balanced runs (ops/kernels/probes.py::chain_plan), keep a
// tile's repeat sum in registers and add it into the zeroed output with
// atomics when they leave the tile: exact in any order, as above.
#include <type_traits>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace pcaudio;
namespace hw = pcaudio::hopper;

constexpr int kBM = 128, kBN = 128;  // a block's output tile
constexpr int kGemmThreads = 384;    // warpgroup 0 loads, 1 and 2 compute
constexpr int kConsumerWarps = 8;
constexpr int kMaxStages = 4;
constexpr int kMaxSlabRows = 256;    // a TMA box's rows
constexpr int kBBox = 64;            // bf16 B boxes: 64 columns x 64 rows of K
constexpr int kBarrierBytes = (2 * kMaxStages + 1) * 8;

struct GemmParams {
  void* out;
  const uint8_t* b;     // s8 B [batch][K][N], staged by the threads
  long long b_batch;    // bytes between B's batches
  long long out_batch;  // elements between out's batches (0: one summed output)
  int N, K, KP, nk;     // K padded to whole 128-byte stages, and their count
  int reps, shift, group, groups, repeats, m_tiles, n_tiles, blocks;
  int stages, slab_rows, accumulate;
};

// Shared memory: the B panel, the ring, the barriers; from a 1,024-byte
// boundary (the swizzle atoms).
__host__ __device__ constexpr int gemm_smem(int b_bytes, int stages, int slab_rows) {
  return hw::kAtomBytes + b_bytes + stages * slab_rows * hw::kSwizzleBytes + kBarrierBytes;
}

template <bool kS8>
__global__ void __launch_bounds__(kGemmThreads, 1)
window_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const GemmParams p) {
  using Acc = typename std::conditional<kS8, int, float>::type;
  constexpr int kEl = kS8 ? 1 : 2;
  constexpr int kKS = hw::kSwizzleBytes / kEl;  // K elements a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((hw::kAtomBytes - (hw::smem_u32(smem_raw) & (hw::kAtomBytes - 1))) &
                              (hw::kAtomBytes - 1));
  const int b_bytes = p.KP * kBN * kEl;
  const int stage_bytes = p.slab_rows * hw::kSwizzleBytes;
  uint8_t* sb = smem;
  uint8_t* ring = smem + b_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * stage_bytes);
  uint64_t* empty = full + kMaxStages;
  uint64_t* b_full = empty + kMaxStages;

  const int panel = blockIdx.x / p.blocks, run = blockIdx.x % p.blocks;
  const int bi = panel / p.n_tiles, nt = panel % p.n_tiles;
  const long long units = (long long)p.m_tiles * p.repeats * p.groups;
  const long long u0 = units * run / p.blocks, u1 = units * (run + 1) / p.blocks;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      hw::mbar_init(&full[i], 1);
      hw::mbar_init(&empty[i], kConsumerWarps);
    }
    hw::mbar_init(b_full, 1);
    hw::mbar_fence_init();
  }
  if constexpr (kS8) {
    // B [K][N] -> K-major: column n of the panel is row n of 128-byte
    // chunks of K, chunk c of K in region c / 8 (128 rows x 128 bytes)
    const uint8_t* bg = p.b + bi * p.b_batch + nt * kBN;
    for (int idx = threadIdx.x; idx < kBN * (p.KP / 16); idx += kGemmThreads) {
      const int n = idx % kBN, kc = idx / kBN;
      uint32_t w[4];
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kc * 16 + e4 * 4 + e;
          const uint32_t byte = k < p.K ? bg[(long long)k * p.N + n] : 0u;
          v |= byte << (8 * e);
        }
        w[e4] = v;
      }
      *reinterpret_cast<uint4*>(sb + (kc / 8) * (kBN * hw::kSwizzleBytes) +
                                hw::swizzle128(n, (kc % 8) * 16)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    hw::fence_proxy_async();  // the threads' stores, then wgmma reads them
  }
  __syncthreads();

  const int wg = hw::warpgroup();
  if (wg == 0) {  // the producer: one thread issues every load
    if (threadIdx.x != 0) return;
    if constexpr (!kS8) {
      hw::mbar_expect_tx(b_full, b_bytes);
      for (int kb = 0; kb < p.KP / kBBox; ++kb)
        for (int h = 0; h < 2; ++h)
          hw::tma_load_3d(sb + h * p.KP * hw::kSwizzleBytes + kb * kBBox * hw::kSwizzleBytes,
                          &map_b, nt * kBN + h * kBBox, kb * kBBox, bi, b_full);
    }
    int stage = 0;
    unsigned phase = 0;
    for (long long u = u0; u < u1; ++u) {
      const int mt = (int)(u / ((long long)p.repeats * p.groups));
      const int j = (int)(u % p.groups);
      const int row0 = mt * kBM + j * p.group * p.shift;
      for (int kq = 0; kq < p.nk; ++kq) {
        hw::mbar_wait(&empty[stage], phase ^ 1);
        hw::mbar_expect_tx(&full[stage], stage_bytes);
        hw::tma_load_3d(ring + stage * stage_bytes, &map_a, kq * kKS, row0, bi, &full[stage]);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup 1 rows 0-63 of the tile, warpgroup 2 rows 64-127
  const int cw = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const uint32_t ring_u = hw::smem_u32(ring), b_u = hw::smem_u32(sb);
  const uint32_t b_lbo = p.KP * hw::kSwizzleBytes;  // bf16: the panel's second 64 columns
  Acc acc[64];  // each tile's first product overwrites it (scale-d 0)
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  if constexpr (!kS8) hw::mbar_wait(b_full, 0);
  int stage = 0, held = -1, cur_mt = -1;
  unsigned phase = 0;
  uint32_t keep = 0;  // scale-d of the next product: 0 starts a tile's sum

  auto flush = [&]() {
    hw::wgmma_wait<0>();
    hw::fence_operand(acc);
    if (held >= 0 && lane == 0) hw::mbar_arrive(&empty[held]);
    held = -1;
    Acc* o = static_cast<Acc*>(p.out) + bi * p.out_batch;
    const int row = cur_mt * kBM + cw * 64 + warp * 16 + lane / 4;
    const int col = nt * kBN + 2 * (lane % 4);
#pragma unroll
    for (int jn = 0; jn < 16; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Acc* q = o + (long long)(row + 8 * h) * p.N + col + 8 * jn;  // 8-byte aligned
        const Acc x = acc[4 * jn + 2 * h], y = acc[4 * jn + 2 * h + 1];
        if (!p.accumulate) {
          if constexpr (kS8)
            *reinterpret_cast<int2*>(q) = make_int2(x, y);
          else
            *reinterpret_cast<float2*>(q) = make_float2(x, y);
        } else if constexpr (kS8) {
          atomicAdd(q, x);
          atomicAdd(q + 1, y);
        } else {
          atomicAdd(reinterpret_cast<float2*>(q), make_float2(x, y));
        }
      }
    keep = 0;
  };

  for (long long u = u0; u < u1; ++u) {
    const int mt = (int)(u / ((long long)p.repeats * p.groups));
    const int j = (int)(u % p.groups);
    const int g = min(p.group, p.reps - j * p.group);
    if (mt != cur_mt) {
      if (cur_mt >= 0) flush();
      cur_mt = mt;
    }
    for (int kq = 0; kq < p.nk; ++kq) {
      hw::mbar_wait(&full[stage], phase);
      hw::wgmma_fence();
      const uint32_t base = ring_u + stage * stage_bytes + cw * 64 * hw::kSwizzleBytes;
      for (int i = 0; i < g; ++i) {
        const uint32_t a_row = base + i * p.shift * hw::kSwizzleBytes;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int q = kq * 4 + ks;  // the k-step over the whole of K
          const uint64_t da = hw::smem_desc(a_row + ks * hw::kKStepBytes, 16, hw::kSbo);
          if constexpr (kS8) {
            const uint64_t db = hw::smem_desc(
                b_u + (q / 4) * (kBN * hw::kSwizzleBytes) + (q % 4) * hw::kKStepBytes, 16,
                hw::kSbo);
            hw::wgmma_s8_ss(acc, da, db, keep);
          } else {
            const uint64_t db = hw::smem_desc(b_u + q * 16 * hw::kSwizzleBytes, b_lbo, hw::kSbo);
            hw::wgmma_bf16_ss<1>(acc, da, db, keep);
          }
          keep = 1;
        }
      }
      hw::wgmma_commit();
      hw::wgmma_wait<1>();  // the group before this one has read its stage
      if (held >= 0 && lane == 0) hw::mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  if (cur_mt >= 0) flush();
}

template <bool kS8>
int launch_gemm(const CUtensorMap& ma, const CUtensorMap& mb, const GemmParams& p, int grid,
                int smem, cudaStream_t st) {
  static bool sized = false;  // ask once for the largest dynamic shared memory
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_gemm_kernel<kS8>, cudaFuncAttributeMaxDynamicSharedMemorySize, hw::kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  window_gemm_kernel<kS8><<<grid, kGemmThreads, smem, st>>>(ma, mb, p);
  return (int)cudaGetLastError();
}

// ---- P4a: the dependent bf16 chain ---------------------------------------

constexpr int kChainThreads = 128;  // one warpgroup: one chain of 64 rows of x
constexpr int kChainRows = 64;
// blocks (chains in flight) an SM, as registers allow: 172 a thread at d
// 128 (64 accumulators, 32 A, 64 repeat sums), 92 at d 64 (ptxas); 3 and 5
// were no faster (PERF.md)
constexpr int kChainBlocksPerSm128 = 2, kChainBlocksPerSm64 = 4;
// stage probe (probes/probe_stages.py CHAIN_VARIANTS): 1 the products
// alone (A kept, no pack), 2 the pack alone (and an unpack, no products)
constexpr int kChainLeaveOut = 0;

// Adds a warpgroup's repeat sums of row tile `tile` into out and zeroes
// them: thread (w, g, q) holds sum[4j + 2h + e] = row 16w + g + 8h, column
// 8j + 2q + e of the tile (the wgmma accumulator layout).
template <int D>
__device__ __forceinline__ void flush_chain(float* out, int tile, float (&sum)[D / 2],
                                            int warp, int g, int q) {
  float* o = out + ((long long)tile * kChainRows + 16 * warp + g) * D + 2 * q;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = o + h * 8 * D + 8 * j;  // 8-byte aligned
      atomicAdd(reinterpret_cast<float2*>(p),
                make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]));
      sum[4 * j + 2 * h] = sum[4 * j + 2 * h + 1] = 0.f;
    }
}

// One warpgroup a block, `blocks` blocks walking units (row tile, repeat)
// u0 .. u1 - 1 in order (ops/kernels/probes.py::chain_plan): each unit is
// one chain of `reps` dependent products of its 64 rows of x by w.
template <int D>
__global__ void __launch_bounds__(kChainThreads,
                                  D == 128 ? kChainBlocksPerSm128 : kChainBlocksPerSm64)
chain_kernel(const __grid_constant__ CUtensorMap map_w, const __nv_bfloat16* __restrict__ x,
             float* __restrict__ out, int reps, int repeats, long long units, int blocks) {
  constexpr int kAcc = D / 2;     // f32 accumulators of m64nD a thread
  constexpr int kSteps = D / 16;  // k16 products a step
  constexpr int kPairs = kAcc / 2;
  constexpr uint32_t kLbo = D * hw::kSwizzleBytes;  // w's second 64 columns
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t w_full;
  uint8_t* sw = smem_raw + ((hw::kAtomBytes - (hw::smem_u32(smem_raw) & (hw::kAtomBytes - 1))) &
                            (hw::kAtomBytes - 1));
  if (threadIdx.x == 0) {
    hw::mbar_init(&w_full, 1);
    hw::mbar_fence_init();
    hw::mbar_expect_tx(&w_full, D * D * 2);
    // w [K][N] as it lies, one box of 64 columns (128 bytes) x D rows a
    // half: wgmma's MN-major B under the 128-byte swizzle
    for (int h = 0; h < D / 64; ++h)
      hw::tma_load_3d(sw + h * D * hw::kSwizzleBytes, &map_w, h * 64, 0, 0, &w_full);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const long long u0 = units * blockIdx.x / blocks, u1 = units * (blockIdx.x + 1) / blocks;
  const uint32_t w_u = hw::smem_u32(sw);
  float acc[kAcc], sum[kAcc];
  uint32_t a[kSteps][4];  // this warp's 16 rows of x as the A fragments
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = sum[i] = 0.f;
  hw::mbar_wait(&w_full, 0);
  int cur = -1;
  for (long long u = u0; u < u1; ++u) {
    const int tile = (int)(u / repeats);
    if (tile != cur) {
      if (cur >= 0) flush_chain<D>(out, cur, sum, warp, g, q);
      cur = tile;
    }
    // a[kk][r]: row 16w + g + 8 (r & 1), k 16kk + 8 (r >> 1) + 2q, + 1
    const __nv_bfloat16* xr = x + ((long long)tile * kChainRows + 16 * warp + g) * D + 2 * q;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[kk][r] = *reinterpret_cast<const uint32_t*>(xr + (r & 1) * 8 * D + kk * 16 +
                                                      (r >> 1) * 8);
    for (int s = 0; s < reps; ++s) {
      if constexpr (kChainLeaveOut != 2) {
        hw::wgmma_fence();  // this step's A fragments, written by the pack
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          // rows 16kk .. 16kk + 15 of w; the first product starts the sums
          const uint64_t db = hw::smem_desc(w_u + kk * 16 * hw::kSwizzleBytes, kLbo, hw::kSbo);
          if constexpr (D == 128)
            hw::wgmma_bf16_rs<1>(acc, a[kk], db, kk ? 1u : 0u);
          else
            hw::wgmma_bf16_rs_n64<1>(acc, a[kk], db, kk ? 1u : 0u);
        }
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_operand(acc);
      }
      if constexpr (kChainLeaveOut == 1) {  // keeps every step's products (never taken)
        if (blocks < 0)
#pragma unroll
          for (int i = 0; i < kAcc; ++i) out[threadIdx.x * kAcc + i] = acc[i];
      }
      if constexpr (kChainLeaveOut != 1) {
        // the product's columns 16kk .. 16kk + 15 are the next A's k-step
        // kk: a[kk][r] = (acc[8kk + 2r], acc[8kk + 2r + 1]) rounded
#pragma unroll
        for (int i = 0; i < kPairs; ++i)
          a[i / 4][i % 4] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
      }
      if constexpr (kChainLeaveOut == 2) {  // each step's pack reads new values
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          acc[2 * i] = __uint_as_float(a[i / 4][i % 4] << 16);
          acc[2 * i + 1] = __uint_as_float(a[i / 4][i % 4] & 0xFFFF0000u);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const float2 v = unpack_bf16(a[i / 4][i % 4]);
      sum[2 * i] += v.x;
      sum[2 * i + 1] += v.y;
    }
  }
  if (cur >= 0) flush_chain<D>(out, cur, sum, warp, g, q);
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
int launch_chain(const CUtensorMap& mw, const void* x, float* out, int reps, int repeats,
                 long long units, int blocks, cudaStream_t st) {
  constexpr int smem = D * D * 2 + hw::kAtomBytes;  // w, from a 1,024-byte boundary
  chain_kernel<D><<<blocks, kChainThreads, smem, st>>>(mw, (const __nv_bfloat16*)x, out, reps,
                                                       repeats, units, blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// A [batch][rows][K], B [batch][K][N], both bf16 (int8 == 0) or s8, one
// batch with `repeats` >= 1 or `batch` >= 1 with one repeat; out f32 or s32
// [batch][M][N], or [M][N] summed over the repeats, zeroed by the caller
// where repeats * ceil(reps / group) > 1 (the kernel then adds into it).
// The plan (`blocks` runs a panel, `group` windows a slab, `stages` in the
// ring) is ops/kernels/probes.py::matmul_plan's.  The integers come as one
// array (fewer arguments for ctypes to convert on each call): int8, batch,
// rows, M, N, K, reps, shift, repeats, blocks, group, stages.
extern "C" int pcaudio_probe_matmul(const void* a, const void* b, void* out, const int* args,
                                    void* stream) {
  const int int8 = args[0], batch = args[1], rows = args[2], M = args[3], N = args[4],
            K = args[5], reps = args[6], shift = args[7], repeats = args[8], blocks = args[9],
            group = args[10], stages = args[11];
  const int el = int8 ? 1 : 2, ks = hw::kSwizzleBytes / el;
  const int slab_rows = kBM + (group - 1) * shift;
  if (M < kBM || N < kBN || M % kBM || N % kBN || K < 1 || (K * el) % 64 || reps < 1 ||
      shift < 0 || rows < M + (reps - 1) * shift || batch < 1 || repeats < 1 ||
      (batch > 1 && repeats > 1) || group < 1 || group > reps ||
      (group > 1 && shift % 8) || slab_rows > kMaxSlabRows || stages < 2 ||
      stages > kMaxStages || blocks < 1 || ((uintptr_t)a | (uintptr_t)b) % 16)
    return (int)cudaErrorInvalidValue;
  GemmParams p{};
  p.out = out;
  p.b = static_cast<const uint8_t*>(b);
  p.b_batch = (long long)K * N * el;
  p.out_batch = repeats > 1 ? 0 : (long long)M * N;
  p.N = N;
  p.K = K;
  p.KP = (K + ks - 1) / ks * ks;
  p.nk = p.KP / ks;
  p.reps = reps;
  p.shift = shift;
  p.group = group;
  p.groups = (reps + group - 1) / group;
  p.repeats = repeats;
  p.m_tiles = M / kBM;
  p.n_tiles = N / kBN;
  p.blocks = blocks;
  p.stages = stages;
  p.slab_rows = slab_rows;
  p.accumulate = repeats * p.groups > 1;
  const int smem = gemm_smem(p.KP * kBN * el, stages, slab_rows);
  if (smem > hw::kMaxSmem) return (int)cudaErrorInvalidValue;
  const auto type = int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap ma, mb;
  const cuuint64_t a_dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t a_strides[2] = {(cuuint64_t)K * el, (cuuint64_t)rows * K * el};
  const cuuint32_t a_box[3] = {(cuuint32_t)ks, (cuuint32_t)slab_rows, 1};
  if (!hw::tensor_map_3d(&ma, type, a, a_dims, a_strides, a_box))
    return (int)cudaErrorInvalidValue;
  mb = ma;
  if (!int8) {
    const cuuint64_t b_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)batch};
    const cuuint64_t b_strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
    const cuuint32_t b_box[3] = {kBBox, kBBox, 1};
    if (!hw::tensor_map_3d(&mb, type, b, b_dims, b_strides, b_box))
      return (int)cudaErrorInvalidValue;
  }
  const int grid = batch * p.n_tiles * blocks;
  const auto st = (cudaStream_t)stream;
  return int8 ? launch_gemm<true>(ma, mb, p, grid, smem, st)
              : launch_gemm<false>(ma, mb, p, grid, smem, st);
}

// x [n][d] bf16, w [d][d] bf16 as it lies (K rows, N contiguous), out
// [n][d] f32 zeroed: out += the chain's result once per repeat.  The
// integers come as one array: n (a multiple of 64), d (64 or 128), reps,
// repeats, blocks (ops/kernels/probes.py::chain_plan).
extern "C" int pcaudio_probe_chain(const void* x, const void* w, void* out, const int* args,
                                   void* stream) {
  const int n = args[0], d = args[1], reps = args[2], repeats = args[3], blocks = args[4];
  if (n < kChainRows || n % kChainRows || (d != 64 && d != 128) || reps < 1 || repeats < 1 ||
      blocks < 1 || ((uintptr_t)x | (uintptr_t)w) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mw;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)d, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)d * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)d, 1};
  if (!hw::tensor_map_3d(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)(n / kChainRows) * repeats;
  const auto st = (cudaStream_t)stream;
  return d == 64 ? launch_chain<64>(mw, x, (float*)out, reps, repeats, units, blocks, st)
                 : launch_chain<128>(mw, x, (float*)out, reps, repeats, units, blocks, st);
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
