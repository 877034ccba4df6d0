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
// Rounding is half to even (as jnp.round and torch.round; here by adding
// 1.5 * 2^23, rint8), multiplies and adds in quantisation are kept apart
// (__fmul_rn, __fadd_rn: no FMA contraction) and its division is IEEE, so
// quantisation matches the plain version bit for bit.  The softmax takes exp(x) as
// ex2(x * log2 e) on the SFU, with log2 e folded into the logits' scale and
// the clip at +-50 log2 e, and a = e * (1 / rowsum): a few ulps of a's
// value, inside attend_bound's margin for a (ops/kernels/probes.py).
//
// What bounds it on the H100: operations.  8,192 attends of 2 x 1024 x
// 128 x 128 multiply-adds (550 GFLOP) on the tensor cores (bf16 989
// TFLOP/s, s8 1,979 TOP/s dense), and 1.07 G exps on the special-function
// units (MUFU, 16 a clock per SM).
//
// Design (redesigned for Hopper): a block is three warpgroups and holds
// 256 query rows.  Warpgroup 0 stages the windows: one thread copies each
// attend's f32 window as two 32 KB halves (keys 0-63, 64-127) with the 1-D
// bulk copy (cp.async.bulk + mbarrier) into a ring of three half-slots, so
// that the next window's first half lands while this one converts; the
// warpgroup converts each window into a two-slot ring of wgmma operands:
// bf16, one key-major copy [key][dv] in two 128-byte swizzled halves of dv,
// which is S = Q K^T's K-major B and A.V's MN-major B alike; int8, the
// key-major k8 (K-major B of the logits) and a dv-major copy with its keys
// permuted (s8 wgmma takes only K-major B; the permutation is the one the
// logits' accumulators give the A.V operand in registers, s8_position),
// quantised with the window's own max.  Each attend converts its own
// window: nothing staged is reused by another (step, pair).  Warpgroups 1
// and 2 hold 128 query rows each, as two 64-row halves: Q (or iq8) in
// swizzled shared memory, the output sums in registers (setmaxnreg moves
// registers from warpgroup 0 to them); per attend and half, S by wgmma
// m64n128k16 / k32 from shared memory, the softmax in registers, and A.V
// by wgmma with P packed from S's accumulators as A in registers.  The
// copies and conversions of the next windows run under these products, and
// each window (copied and converted once) serves 256 rows: half the L2
// reads and conversions of a 128-row block.  Work: the (256-row block,
// attend) units in that order are cut into one contiguous run a block, as
// many blocks as SMs; a block adds its rows' sums into out with atomics
// when its run leaves a row block and at its end (f32: the order of those
// additions varies from run to run).  ops/kernels/probes.py::attend_plan
// is the same plan in Python.
#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace pcaudio;
namespace hw = pcaudio::hopper;

constexpr int kDv = 128, kKeys = 128, kBlockRows = 256, kThreads = 384;
constexpr int kHalfBytes = 64 * kDv * 4;  // 64 keys of an f32 window
constexpr int kOperandBytes = 32768;      // one converted window
constexpr int kQBytes = 128 * kDv * 2;    // a warpgroup's Q (bf16; iq8 uses half)
constexpr int kHalfSlots = 3, kSlots = 2;
constexpr int kConverterWarps = 4, kConsumerWarps = 8;
// setmaxnreg's split of the block's 384 x 168 registers: the bf16
// consumers need 224 (at 216 ptxas serialises their wgmmas and spills);
// the int8 converter, unrolled, runs faster with 64 than with 56
template <bool kInt8>
constexpr int kConverterRegs = kInt8 ? 64 : 56;
template <bool kInt8>
constexpr int kConsumerRegs = kInt8 ? 216 : 224;
static_assert(128 * kConverterRegs<true> + 256 * kConsumerRegs<true> <= 384 * 168 &&
                  128 * kConverterRegs<false> + 256 * kConsumerRegs<false> <= 384 * 168,
              "setmaxnreg asks for more registers than the block holds");
constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kScale2 = (float)(0.125 * 1.4426950408889634);  // 0.125 log2 e
constexpr float kClip2 = (float)(50.0 * 1.4426950408889634);    // 50 log2 e
// Variants that probes/probe_stages.py builds to find what limits the
// kernel (this design: kLeaveOut 0): 1 skips the consumers' products and
// softmax (the copies and conversions alone), 2 the conversions (the
// copies, and the products on whatever the operand ring holds), 3 the
// copies (conversions of whatever the f32 ring holds, and the products).
constexpr int kLeaveOut = 0;
// shared memory: f32 half-window ring, operand ring, Q of the two
// warpgroups, barriers
constexpr int kBarrierOffset = kHalfSlots * kHalfBytes + kSlots * kOperandBytes + 2 * kQBytes;
constexpr int kSmem = hw::kAtomBytes + kBarrierOffset + 128;

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

// Position of key t (< 16) of a 16-key block in the s8 A.V contraction:
// the logits' accumulators of thread q hold keys 8n + 2q, +1 of n-tile n,
// and an s8 A register holds k positions 4q..4q+3, so register reg of a
// k32 step packs keys (8n + 2q, +1, 8(n+1) + 2q, +1) of n = 4 kk + 2 (reg / 2).
__host__ __device__ constexpr int s8_position(int t) {
  return ((t & 7) >> 1) * 4 + ((t >> 3) & 1) * 2 + (t & 1);
}

__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ int window_of(int a, int pairs) {
  return (a / pairs) % pairs + a % pairs;
}

// Conversions on the FMA and integer pipes, where cvt instructions would
// share the conversion unit with the softmax's exps:
//   rint8: round half to even of x (|x| < 2^22) in the low byte of the
//          result: x + 1.5 * 2^23 has an ulp of 1, so the add rounds x to an
//          integer, whose two's complement the low mantissa bits hold;
//   to_float: an s32 (|s| < 2^22) as f32, exactly, the same way back;
//   bf16_bits: f32 -> bf16 to nearest even (finite values), in the high
//          half;
//   pack4 / pack_hi: four low bytes, two high halves, into one word.
__device__ __forceinline__ uint32_t rint8(float x) {
  return __float_as_uint(__fadd_rn(x, 12582912.0f));
}
__device__ __forceinline__ float to_float(int s) {
  return __fsub_rn(__int_as_float(s + 0x4B400000), 12582912.0f);
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return u + 0x7FFFu + ((u >> 16) & 1u);
}
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}
__device__ __forceinline__ uint32_t pack_hi(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
attend_kernel(const float* __restrict__ iq, const int8_t* __restrict__ iq8,
              const float* __restrict__ sq, const float* __restrict__ kmat,
              float* __restrict__ out, int pairs, int attends, long long units) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((hw::kAtomBytes - (hw::smem_u32(smem_raw) & (hw::kAtomBytes - 1))) &
                              (hw::kAtomBytes - 1));
  uint8_t* fring = smem;                                   // [half-slot][64 keys][dv] f32
  uint8_t* oring = smem + kHalfSlots * kHalfBytes;         // [slot] operands
  uint8_t* qs = oring + kSlots * kOperandBytes;            // [warpgroup] Q
  uint64_t* full_f = reinterpret_cast<uint64_t*>(smem + kBarrierOffset);
  uint64_t* full_o = full_f + kHalfSlots;
  uint64_t* empty_o = full_o + kSlots;
  float* red = reinterpret_cast<float*>(empty_o + kSlots);  // [4] warp maxima
  float* s_k = red + 4;                                     // [slot] window scales

  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;
  const int n = (int)(u1 - u0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kHalfSlots; ++i) hw::mbar_init(&full_f[i], 1);
    for (int i = 0; i < kSlots; ++i) {
      hw::mbar_init(&full_o[i], kConverterWarps);
      hw::mbar_init(&empty_o[i], kConsumerWarps);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (hw::warpgroup() == 0) {  // ---- warpgroup 0: copy and convert ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kConverterRegs<kInt8>));
    const int warp = threadIdx.x / 32;
    auto copy = [&](int h) {  // one thread: half h of the run's windows into slot h % 3
      const int a = (int)((u0 + h / 2) % attends);
      hw::mbar_expect_tx(&full_f[h % kHalfSlots], kHalfBytes);
      hw::bulk_load(fring + (h % kHalfSlots) * kHalfBytes,
                    kmat + ((long long)window_of(a, pairs) * kKeys + (h % 2) * 64) * kDv,
                    kHalfBytes, &full_f[h % kHalfSlots]);
    };
    if (threadIdx.x == 0 && kLeaveOut != 3)
      for (int h = 0; h < min(2 * n, kHalfSlots); ++h) copy(h);
    for (int i = 0; i < n; ++i) {
      const int slot = i % kSlots;
      const unsigned ph = (i / kSlots) & 1;
      // keys 0-63 in half-slot (2i) % 3, keys 64-127 in (2i + 1) % 3
      const int s0 = (2 * i) % kHalfSlots, s1 = (2 * i + 1) % kHalfSlots;
      const float4* h0 = reinterpret_cast<const float4*>(fring + s0 * kHalfBytes);
      const float4* h1 = reinterpret_cast<const float4*>(fring + s1 * kHalfBytes);
      auto row4 = [&](int j) { return (j < 64 ? h0 : h1) + (j % 64) * (kDv / 4); };
      uint8_t* op = oring + slot * kOperandBytes;
      if (kLeaveOut != 3) {
        hw::mbar_wait(&full_f[s0], ((2 * i) / kHalfSlots) & 1);
        hw::mbar_wait(&full_f[s1], ((2 * i + 1) / kHalfSlots) & 1);
      }
      hw::mbar_wait(&empty_o[slot], ph ^ 1);
      if constexpr (kLeaveOut == 2) {
      } else if constexpr (!kInt8) {
        // row j: lane l converts dv 4l..4l+3; even lanes store 8 dv (rows
        // unrolled: a warp alone per sub-partition hides its loads' latency
        // only with several in flight)
#pragma unroll 8
        for (int j = warp; j < kKeys; j += kConverterWarps) {
          const float4 v = row4(j)[lane];
          const uint32_t w0 = pack_hi(bf16_bits(v.x), bf16_bits(v.y));
          const uint32_t w1 = pack_hi(bf16_bits(v.z), bf16_bits(v.w));
          const uint32_t o0 = __shfl_down_sync(kFullMask, w0, 1);
          const uint32_t o1 = __shfl_down_sync(kFullMask, w1, 1);
          if (!(lane & 1)) {
            const int c = lane / 2;  // 8-dv chunk: half c / 8, chunk c % 8
            *reinterpret_cast<uint4*>(op + (c / 8) * (kKeys * hw::kSwizzleBytes) +
                                      hw::swizzle128(j, (c % 8) * 16)) =
                make_uint4(w0, w1, o0, o1);
          }
        }
      } else {
        float m = 0.f;
#pragma unroll 8
        for (int j = warp; j < kKeys; j += kConverterWarps) {
          const float4 v = row4(j)[lane];
          m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
        }
        m = warp_max(m);
        if (lane == 0) red[warp] = m;
        named_barrier(1, 128);
        const float s = quant_scale(fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3])));
        const float inv = 1.0f / s;
        auto q8 = [&](float x) { return rint8(__fmul_rn(x, inv)); };
        // key-major k8 [key][dv]: lane l quantises dv 4l..4l+3 of row j
#pragma unroll 8
        for (int j = warp; j < kKeys; j += kConverterWarps) {
          const float4 v = row4(j)[lane];
          const uint32_t w = pack4(q8(v.x), q8(v.y), q8(v.z), q8(v.w));
          const uint32_t w1 = __shfl_down_sync(kFullMask, w, 1);
          const uint32_t w2 = __shfl_down_sync(kFullMask, w, 2);
          const uint32_t w3 = __shfl_down_sync(kFullMask, w, 3);
          if (!(lane & 3))
            *reinterpret_cast<uint4*>(op + hw::swizzle128(j, (lane / 4) * 16)) =
                make_uint4(w, w1, w2, w3);
        }
        // dv-major [dv][key position]: lane l takes dv 32 dg + l, 16 keys
        uint8_t* vt = op + kKeys * hw::kSwizzleBytes;
#pragma unroll 2
        for (int task = warp; task < 32; task += kConverterWarps) {
          const int kb = task % 8, d = (task / 8) * 32 + lane;
          const float* f = reinterpret_cast<const float*>(kb < 4 ? h0 : h1) + (kb % 4) * 16 * kDv;
          uint32_t b[16];
#pragma unroll
          for (int t = 0; t < 16; ++t) b[t] = q8(f[t * kDv + d]);
          uint32_t w[4];  // word q: positions 4q..4q+3 = keys 2q, 2q+1, 8+2q, 9+2q
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            static_assert(s8_position(2) == 4 && s8_position(9) == 3, "s8_position");
            w[q] = pack4(b[2 * q], b[2 * q + 1], b[8 + 2 * q], b[9 + 2 * q]);
          }
          *reinterpret_cast<uint4*>(vt + hw::swizzle128(d, kb * 16)) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
        if (threadIdx.x == 0) s_k[slot] = s;
      }
      hw::fence_proxy_async();  // the stores, for wgmma; the reads, before the refill
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(&full_o[slot]);
      named_barrier(1, 128);  // every thread has read both half-slots
      if (threadIdx.x == 0 && kLeaveOut != 3)
        for (int h = 2 * i + 3; h < min(2 * i + 5, 2 * n); ++h) copy(h);
    }
    return;
  }

  // ---- warpgroups 1 and 2: 128 query rows each, as two halves of 64 ---------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs<kInt8>));
  const int cw = hw::warpgroup() - 1, warp = (threadIdx.x / 32) % 4;
  const int tid = threadIdx.x % 128;
  constexpr int kQHalf = 64 * kDv * (kInt8 ? 1 : 2);  // one half's Q in shared memory
  uint8_t* q_s = qs + cw * kQBytes;
  const uint32_t q_u = hw::smem_u32(q_s), o_u = hw::smem_u32(oring);
  const float s_q = kInt8 ? *sq : 0.f;
  float acc[2][64];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[hh][i] = 0.f;
  int cur_rb = -1;
  uint32_t keep = 1;  // bf16: scale-d of the next A.V's first product

  auto flush = [&]() {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = cur_rb * kBlockRows + cw * 128 + hh * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          atomicAdd(reinterpret_cast<float2*>(out + (row + 8 * h) * kDv + 8 * jn + 2 * (lane % 4)),
                    make_float2(acc[hh][4 * jn + 2 * h], acc[hh][4 * jn + 2 * h + 1]));
    }
    if constexpr (kInt8) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[hh][i] = 0.f;
    } else {
      keep = 0;  // the next A.V overwrites acc (no write of it between wgmmas)
    }
  };

  for (int i = 0; i < n; ++i) {
    const long long u = u0 + i;
    const int rb = (int)(u / attends);
    if (rb != cur_rb) {
      if (cur_rb >= 0) flush();
      cur_rb = rb;
      // this warpgroup's 128 rows of Q into swizzled shared memory (its
      // earlier products have completed: each ended in wgmma_wait<0>)
      const int r0 = rb * kBlockRows + cw * 128;
      if constexpr (kInt8) {
        for (int c = tid; c < 128 * 8; c += 128) {  // 16 dv a chunk
          const int r = c / 8, k = c % 8;
          *reinterpret_cast<uint4*>(q_s + (r / 64) * kQHalf + hw::swizzle128(r % 64, k * 16)) =
              *reinterpret_cast<const uint4*>(iq8 + (long long)(r0 + r) * kDv + k * 16);
        }
      } else {
        for (int c = tid; c < 128 * 16; c += 128) {  // 8 dv a chunk
          const int r = c / 16, k = c % 16;
          const float4* src = reinterpret_cast<const float4*>(iq + (long long)(r0 + r) * kDv + k * 8);
          const float4 x = src[0], y = src[1];
          *reinterpret_cast<uint4*>(q_s + (r / 64) * kQHalf + (k / 8) * (64 * hw::kSwizzleBytes) +
                                    hw::swizzle128(r % 64, (k % 8) * 16)) =
              make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w), pack_bf16(y.x, y.y),
                         pack_bf16(y.z, y.w));
        }
      }
      hw::fence_proxy_async();
      named_barrier(2 + cw, 128);
    }
    const int slot = i % kSlots;
    hw::mbar_wait(&full_o[slot], (i / kSlots) & 1);
    const uint32_t op = o_u + slot * kOperandBytes;
    if constexpr (kLeaveOut == 1) {
    } else if constexpr (!kInt8) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t qh = q_u + hh * kQHalf;
        float s[64];
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {  // over dv: S = Q K^T, K-major both
          const uint64_t da = hw::smem_desc(
              qh + (kk / 4) * (64 * hw::kSwizzleBytes) + (kk % 4) * hw::kKStepBytes, 16, hw::kSbo);
          const uint64_t db = hw::smem_desc(
              op + (kk / 4) * (kKeys * hw::kSwizzleBytes) + (kk % 4) * hw::kKStepBytes, 16,
              hw::kSbo);
          if (kk == 0)
            hw::wgmma_bf16_ss<0, true>(s, da, db);
          else
            hw::wgmma_bf16_ss<0>(s, da, db);
        }
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_operand(s);
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int k = 0; k < 64; ++k) {
          s[k] = ex2(fminf(fmaxf(s[k] * kScale2, -kClip2), kClip2));
          sum[(k / 2) % 2] += s[k];
        }
        float inv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(kFullMask, sum[h], 1);
          sum[h] += __shfl_xor_sync(kFullMask, sum[h], 2);
          inv[h] = 1.0f / sum[h];
        }
        uint32_t pa[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int k = 4 * (2 * kk + r / 2) + 2 * (r % 2);
            pa[kk][r] = pack_hi(bf16_bits(s[k] * inv[r % 2]), bf16_bits(s[k + 1] * inv[r % 2]));
          }
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)  // over keys: A.V, V MN-major (the same copy)
          hw::wgmma_bf16_rs<1>(acc[hh], pa[kk],
                               hw::smem_desc(op + kk * 16 * hw::kSwizzleBytes,
                                             kKeys * hw::kSwizzleBytes, hw::kSbo),
                               kk == 0 ? keep : 1u);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_operand(acc[hh]);
      }
      keep = 1;
    } else {
      const float sk = s_k[slot];
      const float scale = __fmul_rn(__fmul_rn(__fmul_rn(s_q, sk), 0.125f), kLog2e);
      const float sv = sk / 127.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t qh = q_u + hh * kQHalf;
        int s[64];
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = hw::smem_desc(qh + kk * hw::kKStepBytes, 16, hw::kSbo);
          const uint64_t db = hw::smem_desc(op + kk * hw::kKStepBytes, 16, hw::kSbo);
          if (kk == 0)
            hw::wgmma_s8_ss<true>(s, da, db);
          else
            hw::wgmma_s8_ss(s, da, db);
        }
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_operand(s);
        float e[64];
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int k = 0; k < 64; ++k) {  // |s| <= 128 * 127 * 127 < 2^22
          e[k] = ex2(fminf(fmaxf(to_float(s[k]) * scale, -kClip2), kClip2));
          sum[(k / 2) % 2] += e[k];
        }
        float inv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(kFullMask, sum[h], 1);
          sum[h] += __shfl_xor_sync(kFullMask, sum[h], 2);
          inv[h] = 1.0f / sum[h];
        }
        auto a8 = [&](int k) { return rint8(__fmul_rn(e[k] * inv[(k / 2) % 2], 127.f)); };
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            // reg r: rows g / g+8 (r % 2), key half r / 2 of step kk
            const int nt = 4 * kk + 2 * (r / 2), c = 2 * (r % 2);
            pa[kk][r] = pack4(a8(4 * nt + c), a8(4 * nt + c + 1), a8(4 * (nt + 1) + c),
                              a8(4 * (nt + 1) + c + 1));
          }
        int av[64];
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = hw::smem_desc(
              op + kKeys * hw::kSwizzleBytes + kk * hw::kKStepBytes, 16, hw::kSbo);
          if (kk == 0)
            hw::wgmma_s8_rs<true>(av, pa[kk], db);
          else
            hw::wgmma_s8_rs(av, pa[kk], db);
        }
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_operand(av);
#pragma unroll
        for (int k = 0; k < 64; ++k)  // |av| < 2^22
          acc[hh][k] += __fmul_rn(to_float(av[k]), sv);
      }
    }
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&empty_o[slot]);
  }
  if (cur_rb >= 0) flush();
}

template <bool kInt8>
int launch_attend(const float* iq, const int8_t* iq8, const float* sq, const float* kmat,
                  float* out, int rows, int pairs, int steps, int blocks, cudaStream_t st) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(attend_kernel<kInt8>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int attends = steps * pairs;
  const long long units = (long long)(rows / kBlockRows) * attends;
  attend_kernel<kInt8><<<blocks, kThreads, kSmem, st>>>(iq, iq8, sq, kmat, out, pairs, attends,
                                                         units);
  return (int)cudaGetLastError();
}

}  // namespace

// iq [rows][128] f32, kmat [>= (2 pairs - 1) * 128][128] f32, out [rows][128]
// f32 zeroed.  int8: iq8 [rows][128] s8 and sq [1] f32 are scratch for the
// quantised iq.  `blocks` runs of (row block, attend) units, at most one a
// unit (ops/kernels/probes.py::attend_plan).
extern "C" int pcaudio_probe_attend(const void* iq, const void* kmat, void* iq8, void* sq,
                                    void* out, int int8, int rows, int pairs, int steps,
                                    int blocks, void* stream) {
  if (rows < kBlockRows || rows % kBlockRows || pairs < 1 || steps < 1 || blocks < 1 ||
      (long long)blocks > (long long)(rows / kBlockRows) * steps * pairs ||
      ((uintptr_t)iq | (uintptr_t)kmat | (uintptr_t)iq8) % 16)
    return (int)cudaErrorInvalidValue;
  static_assert(kSmem <= hw::kMaxSmem, "the attend's shared memory exceeds a block's");
  const auto st = (cudaStream_t)stream;
  if (!int8)
    return launch_attend<false>((const float*)iq, nullptr, nullptr, (const float*)kmat,
                                (float*)out, rows, pairs, steps, blocks, st);
  quant_kernel<<<1, 1024, 0, st>>>((const float*)iq, rows * kDv, (int8_t*)iq8, (float*)sq);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_attend<true>((const float*)iq, (const int8_t*)iq8, (const float*)sq,
                             (const float*)kmat, (float*)out, rows, pairs, steps, blocks, st);
}
