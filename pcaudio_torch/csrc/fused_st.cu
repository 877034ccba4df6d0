// Kernel K1: the whole Set Transformer forward, one block of 4 warps (8 when
// num_inds > 64) per cloud, bf16 tensor-core products with f32 sums.
//
// Replaces the Pallas kernels pcaudio/ops/kernels/fused_st.py::
// fused_st_forward (`_make_kernel_v6`, serving, and `_make_kernel`, v4,
// masked).  ISAB -> ISAB -> PMA(1 seed) -> Linear with the reference MAB:
//   O = Qp + concat_h softmax(Qp_h Kp_h^T / sqrt(dv)) Vp_h,  out = O + relu(O Wo + bo)
// (feature-split heads, scale 1/sqrt(dv), projected-query residual).  The
// softmax is the exact max-subtract one with v4's mask semantics: masked
// keys are skipped, and a query whose keys are all masked attends to nothing
// (MAB0 and the PMA then give the projected query).  MAB1 is unmasked.
// The mask comes in two forms: a flag a point (mask, [N, K]), which the
// passes read, or a flag a cloud (cloud_mask, [N]; the serving pipeline's
// chunk mask, which masks a chunk's points all or none).  A cloud whose
// flag is clear skips the passes: its MAB0s and its PMA would see no keys,
// so the PMA's output is the projected seed query sq and its logits are
// Linear(sq + relu(bf16(sq) Wo + bo)) whatever its points.  The wrapper
// packs that row after the weights, computed in the kernel's order (the
// same bits as the passes give a dense all-false row), and the block
// copies it (st_empty).  A cloud whose flag is set runs the mask-free
// forward.
//
// Precision is the JAX kernel's: bf16 operands, f32 sums, f32 softmax
// statistics, with bf16 rounding of the points, of each MAB's projected K
// and V, of the probabilities before A.V, of the input of every product
// (the rFF's, the queries' of the scores) and of each ISAB's output.  The
// probabilities are rounded unnormalised (relative to the running max of
// a 64-key chunk) and A.V divided by their f32 sum at the end, where the
// JAX kernel rounds them normalised; the PMA's A.V is an f32 sum (one
// query, no tensor-core product), so its probabilities stay f32.  The plain
// version (fused_st.py::fused_st_forward_plain) computes in this order.
//
// What bounds it on the H100: about 20 MFLOP of products a 128-point cloud
// (0.9 ms at the bench's 44,032 clouds on bf16 tensor cores) but 263,168
// softmax exps (MAB0 64 x 8 x K and MAB1 K x 8 x 64 per ISAB, twice, plus
// the PMA's 8 x K): 2.77 ms on the special-function units.  So the design
// spends one FFMA and one ex2 on each score and keeps the rest off shared
// memory:
//  - every product is mma.sync: projections m16n8k16 (16 rows of a warp x
//    64 outputs), scores m16n8k8 (k = the head width 8), P.V m16n8k16 (n =
//    the head width); a projection's C fragments are the A fragments of the
//    next product (the rFF, K and V of the next MAB, a head's queries), and
//    two score tiles' C fragments the A fragment of P.V, so no score and no
//    projection between two products touches shared memory;
//  - each score is computed once, with an online softmax over key chunks
//    of at most 64 (log2(e)/sqrt(64) applied in the FFMA that feeds ex2);
//  - keys that scale with the cloud (MAB0's and the PMA's) are projected a
//    tile of 16 x warps points at a time and consumed at once; only ISAB
//    1's output [K, 64] bf16 is kept for the cloud (18 KB at K = 128 with
//    its padded rows), so a cloud takes 57 KB of shared memory at K = 128
//    and three clouds are in flight on an SM; the limit is 1,280 points
//    (num_inds <= 64);
//  - the weights (136 KB in bf16) do not fit beside that; they are packed
//    in mma B-fragment order (fused_st.py::_packed_weights), one 8-byte
//    load a lane a product, read through L1 and L2.
// Measured (PERF.md), it takes 3.8 x the exp bound and is held by
// latency, not by the SFU: without its exps it is 10 % faster.  Three
// blocks of 4 warps an SM fill the register file (168 registers, with
// spills), each head's softmax is a chain of dependent steps (mma, max,
// shuffles, ex2, pack, mma), and the weight fragments come from L1 or L2.
// Two blocks an SM without spills measured slower.
// Three passes over the point tiles:
//   A  ISAB 1 MAB0: the inducing queries attend over the points' K0, V0;
//   B  ISAB 1 MAB1 (each point attends over H1) -> ISAB 1's output X1 ->
//      ISAB 2's MAB0 keys, consumed by its inducing queries at once;
//   C  ISAB 2 MAB1 over X1 -> X2 -> the PMA's keys, consumed by the seed
//      (per warp, then merged), then the PMA's rFF and the output Linear.
// A and B hold 80 registers of online state for the inducing queries and
// synchronise the block twice a tile; C needs no barrier until its end.
// The device code is in fused_st.cuh; this file holds the shared-memory
// form, fused_st_scratch.cu the form for larger clouds (X1 in device
// memory), and the two compile beside each other.

#include "fused_st.cuh"

namespace {

// The shared-memory form, one block a cloud: K <= max_points(M).
template <int DIN, int NW>
__global__ void __launch_bounds__(NW * 32, NW == 4 ? 3 : 1)
fused_st_kernel(const void* __restrict__ points, int points_bf16,
                const uint8_t* __restrict__ mask, const uint8_t* __restrict__ cloud_mask,
                const bf16* __restrict__ wbuf, const float* __restrict__ fbuf,
                float* __restrict__ out, int K, int M, int ncls, int passes) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (!has_points(blockIdx.x, cloud_mask)) {
    st_empty<NW>(blockIdx.x, fbuf, out, M, ncls);
    return;
  }
  st_forward<DIN, NW, false>(blockIdx.x, points, points_bf16, mask, wbuf, fbuf, out, K, M,
                             ncls, passes, smem, nullptr);
}

template <int DIN, int NW>
int launch(const void* points, int points_bf16, const uint8_t* mask, const uint8_t* cm,
           const bf16* wb, const float* wf, float* out, int N, int K, int M, int ncls,
           int passes, cudaStream_t stream) {
  const size_t smem = smem_bytes(K, NW);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      fused_st_kernel<DIN, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_st_kernel<DIN, NW><<<N, NW * 32, smem, stream>>>(points, points_bf16, mask, cm, wb, wf,
                                                         out, K, M, ncls, passes);
  return (int)cudaGetLastError();
}

}  // namespace

// The most points a cloud may have for num_inds M (the shared memory of
// one block); 0 if M is outside 1 .. 128.
extern "C" int pcaudio_fused_st_max_points(int M) {
  if (M < 1 || M > 128) return 0;
  const int warps = M <= 64 ? 4 : 8, kt = tile_rows(warps);
  int k = 0;
  while (smem_bytes(k + kt, warps) <= kMaxSmem) k += kt;
  return k;
}

// mask: nullptr or [N, K] flags (one a point); cloud_mask: nullptr or [N]
// flags (one a cloud); at most one of them.
extern "C" int pcaudio_fused_st(const void* points, int points_bf16, const void* mask,
                                const void* cloud_mask, const void* wb, long long n_bf16,
                                const void* wf, long long n_f32, void* out, int N, int K,
                                int din, int M, int ncls, int passes, void* stream) {
  if (N < 1 || K < 1 || ncls < 1 || ncls > 256 || passes < 1 || passes > 3 ||
      (mask != nullptr && cloud_mask != nullptr) || K > pcaudio_fused_st_max_points(M))
    return (int)cudaErrorInvalidValue;
  if (n_bf16 != packed_bf16(din, M, ncls) || n_f32 != packed_f32(M, ncls))
    return (int)cudaErrorInvalidValue;
  const auto m = (const uint8_t*)mask;
  const auto cm = (const uint8_t*)cloud_mask;
  const auto b = (const bf16*)wb;
  const auto f = (const float*)wf;
  const auto st = (cudaStream_t)stream;
  const bool wide = M > 64;
  if (din == 2) {
    return wide ? launch<2, 8>(points, points_bf16, m, cm, b, f, (float*)out, N, K, M, ncls, passes, st)
                : launch<2, 4>(points, points_bf16, m, cm, b, f, (float*)out, N, K, M, ncls, passes, st);
  }
  if (din == 3) {
    return wide ? launch<3, 8>(points, points_bf16, m, cm, b, f, (float*)out, N, K, M, ncls, passes, st)
                : launch<3, 4>(points, points_bf16, m, cm, b, f, (float*)out, N, K, M, ncls, passes, st);
  }
  return (int)cudaErrorInvalidValue;
}
