// K5: the Audio Spectrogram Transformer's self-attention forward in bf16,
// softmax(Q K^T * scale) V over every key (no mask) at head width 64, for
// each (clip, head).  It replaces no TPU kernel: the JAX package has no
// AST.  It was added because the AST's attention (1,214 tokens, 12 heads of
// 64) is a fifth of the model's FLOPs and K4 (csrc/mha.cu) takes only head
// widths up to 16, in 3xTF32.
//
// Layout: Q, K and V are read where the fused QKV product left them,
// qkv [B, N, 3, H, 64] bf16 (the Linear's output [B, N, 3 H 64]), by three
// 3-D TMA tensor maps over (dh, B N rows, H) with a row stride of 3 H 64
// elements and bases at Q, K and V: no transposed copy.  The output is
// written as [B, N, H 64] bf16, the out-projection's input.
//
// What bounds it on the H100: the exps and the tensor cores, about evenly.
// Per (clip, head) 4 N^2 64 FLOPs of bf16 products (989 TFLOP/s) and N^2
// exps on the special-function units (16 a clock per SM): at N = 1,214
// both come to about 7.0 ms for the 128 clips x 12 layers x 12 heads of an
// AST serving batch.  Q, K, V and O are 4 B N H 64 x 2 bytes a layer,
// under 0.1 ms of HBM time.
//
// Design: a block holds 128 query rows of one (clip, head), as two
// warpgroups of 64 rows; both read the same ring of three 64-key stages
// of K and V, each stage loaded once by TMA (128-byte swizzle) and
// released by the 8 warps' arrivals on its mbarrier; warp 0 refills a
// stage once all 8 have released it.  Per stage and warpgroup: S = Q K^T
// by four wgmma m64n64k16 from shared memory (both K-major), the online
// softmax in f32 registers (row maxima and sums over the 4 threads of a
// row; exp2 on the SFU with scale * log2 e folded into one FMA), P packed
// from S's accumulators into bf16 A fragments in registers, and O += P V
// by four wgmma m64n64k16 with V MN-major (as it lies).  The key tail
// (N need not be a multiple of 64) is masked in the last tile only: keys
// at or past N read the next clip's rows (or zeros past the last clip),
// whose scores are set to -inf.  Query rows at or past N compute likewise
// and are not stored.  Blocks run the query tiles of one (clip, head) next
// to each other, so its K and V are read from HBM about once.
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace pcaudio;
namespace hw = pcaudio::hopper;

constexpr int kDh = 64;
constexpr int kBlockRows = 128;  // two warpgroups of 64 query rows
constexpr int kThreads = 256;
constexpr int kKeys = 64;        // keys a stage
constexpr int kStages = 3;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = kKeys * kDh * 2;    // K or V of a stage: 8 KB
constexpr int kQBytes = kBlockRows * kDh * 2;  // 16 KB
constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
// barriers: Q's, a full and an empty one a stage
constexpr int kSmem = hw::kAtomBytes + kBarOffset + (1 + 2 * kStages) * 8;
static_assert(kSmem <= hw::kMaxSmem, "K5's shared memory exceeds a block's");

__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                int n, int heads, int qtiles, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((hw::kAtomBytes - (hw::smem_u32(smem_raw) & (hw::kAtomBytes - 1))) &
                              (hw::kAtomBytes - 1));
  uint8_t* q_s = smem;                             // [128 rows][64] swizzled
  uint8_t* k_s = smem + kQBytes;                   // [stage][64 keys][64]
  uint8_t* v_s = k_s + kStages * kTileBytes;       // [stage][64 keys][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int tile = blockIdx.x % qtiles;
  const int bh = blockIdx.x / qtiles;
  const int h = bh % heads, b = bh / heads;
  const int row0 = b * n;  // the clip's first row of B N
  const int ntiles = (n + kKeys - 1) / kKeys;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int wg = hw::warpgroup();

  auto load = [&](int j) {  // one thread: keys j * 64 .. into stage j % 3
    const int s = j % kStages;
    hw::mbar_expect_tx(&full[s], 2 * kTileBytes);
    hw::tma_load_3d(k_s + s * kTileBytes, &k_map, 0, row0 + j * kKeys, h, &full[s]);
    hw::tma_load_3d(v_s + s * kTileBytes, &v_map, 0, row0 + j * kKeys, h, &full[s]);
  };
  if (threadIdx.x == 0) {
    hw::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], kWarps);
    }
    hw::mbar_fence_init();
    hw::mbar_expect_tx(q_full, kQBytes);
    hw::tma_load_3d(q_s, &q_map, 0, row0 + tile * kBlockRows, h, q_full);
    for (int j = 0; j < min(kStages, ntiles); ++j) load(j);
  }
  __syncthreads();

  const uint32_t qa = hw::smem_u32(q_s + wg * 64 * hw::kSwizzleBytes);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  // thread t holds rows 16 warp + lane / 4 (r 0) and + 8 (r 1); m in units
  // of log2, l the sum over this thread's columns only
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  hw::mbar_wait(q_full, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages;
    hw::mbar_wait(&full[s], (j / kStages) & 1);
    const uint32_t ka = hw::smem_u32(k_s + s * kTileBytes);
    const uint32_t va = hw::smem_u32(v_s + s * kTileBytes);
    float sc[32];
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // over dh: S = Q K^T, both K-major
      const uint64_t da = hw::smem_desc(qa + kk * hw::kKStepBytes, 16, hw::kSbo);
      const uint64_t db = hw::smem_desc(ka + kk * hw::kKStepBytes, 16, hw::kSbo);
      if (kk == 0)
        hw::wgmma_bf16_ss_n64<0, true>(sc, da, db);
      else
        hw::wgmma_bf16_ss_n64<0>(sc, da, db);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_operand(sc);
    // sc[4c + 2r + e]: row r, key 8c + 2 (lane % 4) + e of the tile
    if ((j + 1) * kKeys > n) {
      const int lim = n - j * kKeys;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (8 * (i / 4) + 2 * (lane % 4) + (i % 2) >= lim) sc[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float alpha[2], mneg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 2));
      // every tile holds a valid key, so the new maximum is finite
      const float mnew = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = ex2(m[r] - mnew);
      m[r] = mnew;
      mneg[r] = -mnew;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = ex2(fmaf(sc[i], scale_log2, mneg[(i / 2) % 2]));
      rs[(i / 2) % 2] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    uint32_t pa[4][4];  // P as A fragments: k step kk holds keys 16 kk ..
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = 4 * (2 * kk + r / 2) + 2 * (r % 2);
        pa[kk][r] = pack_bf16(sc[k], sc[k + 1]);
      }
    hw::fence_operand(o);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i / 2) % 2];
    hw::fence_operand(o);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // over keys: O += P V, V MN-major
      hw::wgmma_bf16_rs_n64<1>(o, pa[kk],
                               hw::smem_desc(va + kk * 16 * hw::kSwizzleBytes, kTileBytes,
                                             hw::kSbo));
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_operand(o);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&empty[s]);
    if (threadIdx.x < 32 && j + kStages < ntiles) {  // warp 0 refills the stage
      hw::mbar_wait(&empty[s], (j / kStages) & 1);
      if (lane == 0) load(j + kStages);
      __syncwarp();
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
    inv[r] = 1.0f / l[r];
  }
  const int q0 = tile * kBlockRows + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + 8 * r;
    if (q >= n) continue;
    __nv_bfloat16* dst = out + ((long long)(row0 + q) * heads + h) * kDh + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<uint32_t*>(dst + 8 * c) =
          pack_bf16(o[4 * c + 2 * r] * inv[r], o[4 * c + 2 * r + 1] * inv[r]);
  }
}

}  // namespace

// qkv [B, N, 3, H, 64] bf16 (16-byte aligned), out [B, N, H, 64] bf16;
// scale multiplies Q K^T.  Returns a cudaError_t (0: launched).
extern "C" int pcaudio_attn_fwd(const void* qkv, void* out, int B, int N, int heads, float scale,
                                void* stream) {
  if (B < 1 || N < 1 || heads < 1 || (long long)B * N > (1LL << 30) ||
      (long long)B * heads * ((N + kBlockRows - 1) / kBlockRows) > 0x7fffffffLL ||
      ((uintptr_t)qkv | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const auto* base = static_cast<const __nv_bfloat16*>(qkv);
  const cuuint64_t dims[3] = {(cuuint64_t)kDh, (cuuint64_t)B * N, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)3 * heads * kDh * 2, (cuuint64_t)kDh * 2};
  const cuuint32_t qbox[3] = {kDh, kBlockRows, 1}, kbox[3] = {kDh, kKeys, 1};
  CUtensorMap q_map, k_map, v_map;
  if (!hw::tensor_map_3d(&q_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, qbox) ||
      !hw::tensor_map_3d(&k_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base + heads * kDh, dims,
                         strides, kbox) ||
      !hw::tensor_map_3d(&v_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base + 2 * heads * kDh, dims,
                         strides, kbox))
    return (int)cudaErrorInvalidValue;
  const int qtiles = (N + kBlockRows - 1) / kBlockRows;
  const float scale_log2 = scale * 1.4426950408889634f;
  attn_fwd_kernel<<<B * heads * qtiles, kThreads, kSmem, (cudaStream_t)stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), N, heads, qtiles, scale_log2);
  return (int)cudaGetLastError();
}
