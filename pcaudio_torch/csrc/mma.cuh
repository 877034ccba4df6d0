// mma.sync building blocks shared by K1 (fused_st.cu), K4's forward (mha.cu)
// and the probe kernels (probe_mma.cu, probe_attend.cu): ldmatrix loads from
// shared memory, the bf16, s8 and TF32 tensor-core products, cp.async
// copies, the SFU's 2^x.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16 / k32"),
// with g = lane / 4 and t = lane % 4.  A tile is 16 rows x 32 bytes of K
// (16 bf16 or 32 s8 values), B a tile of 8 columns x 32 bytes of K stored
// column by column (K contiguous), C 16 x 8 f32 or s32:
//   A regs 0..3: (row g, bytes 0-15), (row g+8, bytes 0-15),
//                (row g, bytes 16-31), (row g+8, bytes 16-31); thread t holds
//                bytes 4t..4t+3 of each;
//   B regs 0..1: (column g, bytes 4t..4t+3), (column g, bytes 16+4t..);
//   C regs 0..3: (row g, columns 2t, 2t+1), (row g+8, columns 2t, 2t+1).
// The byte layout is the same for bf16 (k16) and s8 (k32), so one loader
// serves both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace pcaudio {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 matrices of 16-bit words; lane l gives the address of row l % 8
// of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// 16 bytes if `bytes` is 16; with `bytes` 0 nothing is read (`gmem` need
// only be a valid address) and the 16 bytes at `smem` are zero-filled.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Address of lane `lane`'s row for an A fragment (16 rows x 32 bytes at
// `tile`, rows `stride` bytes apart): rows 0-15, byte half lane / 16.
__device__ __forceinline__ const uint8_t* a_frag_row(const uint8_t* tile, int stride,
                                                     int lane) {
  return tile + (lane & 15) * stride + (lane >> 4) * 16;
}
// ... and for two B fragments side by side (columns 0-7 and 8-15, 32 bytes
// of K each): regs 0-1 of the x4 load are the first, regs 2-3 the second.
__device__ __forceinline__ const uint8_t* b_frag_row(const uint8_t* tile, int stride,
                                                     int lane) {
  return tile + ((lane & 7) + ((lane >> 4) << 3)) * stride + ((lane >> 3) & 1) * 16;
}

struct MmaBf16 {  // mma.sync.aligned.m16n8k16, bf16 x bf16 -> f32
  using Acc = float;
  static constexpr const char* kName = "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32";
  __device__ __forceinline__ static void mma(float (&c)[4], const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

struct MmaS8 {  // mma.sync.aligned.m16n8k32, s8 x s8 -> s32
  using Acc = int;
  static constexpr const char* kName = "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32";
  __device__ __forceinline__ static void mma(int (&c)[4], const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// Two f32 as a bf16 pair (round to nearest even), the lower k first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// ldmatrix_x4 with each 8x8 matrix transposed: lane l then holds, of matrix
// i, the words (rows 2(l%4), 2(l%4)+1; column l/4), the B fragment of a
// row-major [k, n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b, bf16 operands, f32 sums, without `volatile`, so the compiler may
// schedule these freely (the probe kernels' MmaBf16 keeps program order).
// m16n8k16: a as above, b = {b0, b1}.
__device__ __forceinline__ void mma_bf16_k16(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// m16n8k8: A regs (row g, k 2t..2t+1), (row g+8, k 2t..2t+1); B (k 2t..2t+1,
// column g); C as for k16.
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], const uint32_t (&a)[2],
                                            uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// TF32 (10-bit mantissa) products with f32 sums, mma.sync.m16n8k8, with
// g = lane / 4, t = lane % 4 (PTX ISA, "Matrix fragments for mma.m16n8k8",
// .tf32):
//   A regs 0..3: (row g, k t), (row g+8, k t), (row g, k t+4), (row g+8, k t+4);
//   B regs 0..1: (k t, column g), (k t+4, column g);
//   C as for k16: (row g, columns 2t, 2t+1), (row g+8, columns 2t, 2t+1).
// The unit reads the top 19 bits of each operand (sign, exponent, 10
// mantissa bits) and ignores the low 13: an f32 operand is truncated.
__device__ __forceinline__ void mma_tf32_k8(float (&c)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x ≈ hi + lo: hi = x rounded to TF32, to nearest with ties away from zero
// (half a TF32 ulp added to the bit pattern, the low 13 bits cleared: what
// cvt.rna.tf32.f32 gives, in integer operations, where a cvt would take the
// conversion unit that exps need); lo = x - hi, exact in f32, which the
// unit reads truncated: |x - hi - lo| <= 2^-21 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 3xTF32: c += a·b to about 2^-20 of sum |a·b| (f32 is 2^-24), as
// lo·hi + hi·lo + hi·hi, the small terms first; lo·lo (2^-22) is dropped.
__device__ __forceinline__ void mma_3xtf32_k8(float (&c)[4], const uint32_t (&a_hi)[4],
                                              const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                              uint32_t b1_hi, uint32_t b0_lo,
                                              uint32_t b1_lo) {
  mma_tf32_k8(c, a_lo, b0_hi, b1_hi);
  mma_tf32_k8(c, a_hi, b0_lo, b1_lo);
  mma_tf32_k8(c, a_hi, b0_hi, b1_hi);
}

// 2^x on the special-function unit (2 ulp; -inf gives +0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four s8 values (already integers in [-128, 127]) as one register, the
// first in the lowest byte.
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

}  // namespace pcaudio
