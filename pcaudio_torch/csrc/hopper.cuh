// Hopper (sm_90a) building blocks shared by the wgmma kernels
// (probe_mma.cu's windowed GEMM, probe_attend.cu's v6 attend):
//
//   - mbarriers: init, arrive, arrive with an expected byte count, wait on
//     a phase parity;
//   - TMA: 2-D and 3-D tiled loads through a tensor map, and the 1-D bulk
//     copy, each completing on an mbarrier; the proxy fence a thread issues
//     after writing shared memory that wgmma or TMA will then read;
//   - the wgmma shared-memory matrix descriptor for the 128-byte swizzle;
//   - wgmma m64n128k16 (bf16 -> f32) and m64n128k32 (s8 -> s32), A from
//     shared memory or registers, with the warpgroup fence, commit and
//     wait;
//   - on the host, tiled tensor maps from cuTensorMapEncodeTiled, reached
//     through the runtime's driver entry point (no -lcuda), cached by
//     pointer and shape.
//
// The 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B, descriptor layout 1):
// a tile is stored as rows of 128 bytes, 8 rows (1,024 bytes) to an atom,
// and within an atom the 16-byte chunk c of row r sits at chunk c ^ (r % 8).
// The pattern is a function of the shared address bits (bits 4-6 XOR bits
// 7-9), so every atom starts on a 1,024-byte boundary and the descriptor's
// base offset is 0.  Canonical layouts (PTX ISA, "Shared memory matrix
// layout"; CUTLASS's GmmaDescriptor), in bytes:
//   K-major  (rows = M or N, 128 bytes of K each): 8-row groups kSbo apart
//            along M/N; the leading offset is unused (1 by convention);
//            a k-step of 32 bytes moves the start address by 32.
//   MN-major (rows = K, 128 bytes of M or N each): 8-row groups of K kSbo
//            apart; atoms along M/N `lbo` apart (the second 64 bf16 columns
//            of an n128 product); a k16 step moves the start by 2,048.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>

namespace pcaudio {
namespace hopper {

constexpr int kSwizzleBytes = 128;  // a swizzled row
constexpr int kAtomBytes = 1024;    // 8 rows: one swizzle atom
constexpr int kSbo = 1024;          // stride between 8-row groups
constexpr int kKStepBytes = 32;     // K bytes of one wgmma (k16 bf16, k32 s8)
constexpr int kLayoutSwizzle128 = 1;  // descriptor bits 62-63
constexpr int kMaxSmem = 232448;    // 227 KB of dynamic shared memory a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The byte offset, inside a 128-byte-swizzled tile whose atoms start on
// 1,024-byte boundaries, of byte `col` (< 128) of row `row`.
__host__ __device__ __forceinline__ uint32_t swizzle128(uint32_t row, uint32_t col) {
  return row * kSwizzleBytes + ((((col >> 4) ^ (row & 7)) << 4) | (col & 15));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// After the inits, before any thread (or the TMA unit) uses the barriers.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` more of transfers (TMA) to land.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// ---- TMA ----------------------------------------------------------------

// Generic-proxy writes (or reads) of shared memory made visible to (or
// ordered before) the async proxy: wgmma operand reads and TMA writes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar` (whose expected bytes the caller set).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma --------------------------------------------------------------

// The descriptor of a 128-byte-swizzled operand starting at shared address
// `addr`, with leading and stride byte offsets `lbo`, `sbo` (multiples of
// 16; bits 0-13 address >> 4, 16-29 lbo >> 4, 32-45 sbo >> 4, 62-63 the
// layout).
__host__ __device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                                       uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)kLayoutSwizzle128 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma in flight (the asm statements carry no register
// dependence on the wait).
__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_operand(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define PCAUDIO_D4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define PCAUDIO_D16(c, i) \
  PCAUDIO_D4(c, i), PCAUDIO_D4(c, i + 4), PCAUDIO_D4(c, i + 8), PCAUDIO_D4(c, i + 12)
#define PCAUDIO_D64(c) \
  PCAUDIO_D16(c, 0), PCAUDIO_D16(c, 16), PCAUDIO_D16(c, 32), PCAUDIO_D16(c, 48)
#define PCAUDIO_R64                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "    \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, " \
  "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// Products from shared memory come in two forms.  kZero false: D += A B,
// where a runtime `scale_d` of 0 drops D's old value (D = A B) without the
// threads writing D (a write of the accumulators between wgmmas, as a
// zeroing in a branch, makes ptxas serialise them).  kZero true: D = A B
// with D's registers written only, so that they are not live before the
// product.  (scale-d is a predicate operand, set from its integer.)

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 operands, f32 sums.  A from
// shared memory, K-major; B K-major (kTransB 0) or MN-major (kTransB 1).
// Thread t of the warpgroup holds, with w = t / 32, g = (t % 32) / 4,
// q = t % 4: d[4j + 2h + e] = D[16w + g + 8h][8j + 2q + e].
template <int kTransB, bool kZero = false>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[64], uint64_t a, uint64_t b,
                                              uint32_t scale_d = 1) {
  if constexpr (kZero)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PCAUDIO_R64
        ", %64, %65, p, 1, 1, 0, %67;\n}\n"
        : PCAUDIO_D64("=f")
        : "l"(a), "l"(b), "n"(0), "n"(kTransB));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PCAUDIO_R64
        ", %64, %65, p, 1, 1, 0, %67;\n}\n"
        : PCAUDIO_D64("+f")
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB));
}

// D[64 x 128] (+)= A B with A from registers (scale_d as above): a[0..3]
// of warp w hold, as for mma.sync.m16n8k16, rows 16w + g (regs 0, 2) and
// 16w + g + 8 (1, 3), k 2q, 2q + 1 (regs 0, 1) and 8 + 2q, 9 + 2q (2, 3).
template <int kTransB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b, uint32_t scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PCAUDIO_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : PCAUDIO_D64("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
}

// D[64 x 128] (+)= A[64 x 32] B[32 x 128], s8 operands, s32 sums; both
// K-major (s8 takes no transpose).  A from shared memory.
template <bool kZero = false>
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[64], uint64_t a, uint64_t b,
                                            uint32_t scale_d = 1) {
  if constexpr (kZero)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " PCAUDIO_R64
        ", %64, %65, p;\n}\n"
        : PCAUDIO_D64("=r")
        : "l"(a), "l"(b), "n"(0));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " PCAUDIO_R64
        ", %64, %65, p;\n}\n"
        : PCAUDIO_D64("+r")
        : "l"(a), "l"(b), "r"(scale_d));
}

// ... with A from registers: as for mma.sync.m16n8k32, regs 0 and 2 rows
// 16w + g, 1 and 3 rows 16w + g + 8; bytes 4q..4q+3 of k 0-15 (regs 0, 1)
// and of k 16-31 (2, 3).
template <bool kZero = false>
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kZero)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " PCAUDIO_R64
        ", {%64, %65, %66, %67}, %68, p;\n}\n"
        : PCAUDIO_D64("=r")
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(0));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " PCAUDIO_R64
        ", {%64, %65, %66, %67}, %68, p;\n}\n"
        : PCAUDIO_D64("+r")
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// The warpgroup of the calling thread, as a value the compiler knows to be
// the same across the warp (CUTLASS's canonical_warp_group_idx): branches
// on it are not divergent, so ptxas need not serialise the wgmmas after.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x / 128), 0);
}

#undef PCAUDIO_D4
#undef PCAUDIO_D16
#undef PCAUDIO_D64
#undef PCAUDIO_R64

// ---- host: tensor maps --------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? (EncodeTiledFn)p : nullptr;
  }();
  return fn;
}

// A 3-D tiled map (dims and box innermost first, strides in bytes of dims
// 1 and 2) with the 128-byte swizzle; out-of-bounds elements read as zero.
// The last few maps are cached by their arguments, so that a repeated call
// does not encode again.  Returns false where the driver refuses.
inline bool tensor_map_3d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                          const cuuint64_t (&dims)[3], const cuuint64_t (&strides)[2],
                          const cuuint32_t (&box)[3]) {
  struct Entry {
    CUtensorMapDataType type;
    const void* base;
    cuuint64_t dims[3], strides[2];
    cuuint32_t box[3];
    CUtensorMap map;
  };
  constexpr int kEntries = 16;
  static Entry cache[kEntries];
  static int used = 0, next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.type == type && e.base == base && !std::memcmp(e.dims, dims, sizeof dims) &&
        !std::memcmp(e.strides, strides, sizeof strides) && !std::memcmp(e.box, box, sizeof box)) {
      *map = e.map;
      return true;
    }
  }
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return false;
  Entry e{type, base, {dims[0], dims[1], dims[2]}, {strides[0], strides[1]},
          {box[0], box[1], box[2]}, {}};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&e.map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache[next] = e;
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  *map = e.map;
  return true;
}

}  // namespace hopper
}  // namespace pcaudio
