// Kernel K1's scratch form: the same Set Transformer forward as
// fused_st.cu (the device code is fused_st.cuh), for clouds whose ISAB 1
// output X1 [Kp, 64] bf16 does not fit in shared memory beside the
// tiles: the full 5,120-point temporal grids (737 KB of X1 at the
// shared form's row stride) that the JAX fused ST takes at any size.
//
// X1 goes to a slab of a scratch buffer in device memory instead, in
// A-fragment order, 128 bytes a row (store_afrag_global /
// load_afrag_global): pass B writes each warp's rows and pass C reads
// them back in the same lanes, so nothing else changes and both forms
// give the same bits.  The grid is persistent: as many blocks as are
// resident (the occupancy query) or as the scratch holds slabs, each
// walking clouds blockIdx.x, + gridDim.x, ... and reusing its slab, so
// the scratch is grid x Kp x 128 bytes whatever the number of clouds
// (the wrapper caps it at 256 MiB: 396 slabs of 655 KB at 5,120 points
// on 132 SMs with 3 blocks each).  A slab is written and read back once
// a cloud: 1.3 MB of traffic against about 10.5 M exps, so the exps
// bound it as they bound the shared form.

#include "fused_st.cuh"

namespace {

// The scratch form, for clouds whose X1 does not fit in shared memory (the
// full 5,120-point grids): a persistent grid of as many blocks as are
// resident (or as the scratch holds), each walking clouds blockIdx.x,
// + gridDim.x, ... with its own slab of scratch for X1, reused from cloud
// to cloud, so the scratch is grid x Kp x 128 bytes whatever N is.
template <int DIN, int NW>
__global__ void __launch_bounds__(NW * 32, NW == 4 ? 3 : 1)
fused_st_scratch_kernel(const void* __restrict__ points, int points_bf16,
                        const uint8_t* __restrict__ mask,
                        const uint8_t* __restrict__ cloud_mask,
                        const bf16* __restrict__ wbuf, const float* __restrict__ fbuf,
                        float* __restrict__ out, int N, int K, int M, int ncls,
                        uint4* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* slab = scratch + blockIdx.x * slab_uint4(K, NW);
  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    if (has_points(n, cloud_mask)) {
      st_forward<DIN, NW, true>(n, points, points_bf16, mask, wbuf, fbuf, out, K, M, ncls, 3,
                                smem, slab);
    } else {
      st_empty<NW>(n, fbuf, out, M, ncls);
    }
    __syncthreads();   // the next cloud's flags overwrite this one's
  }
}

template <int DIN, int NW>
int scratch_attrs(int K, size_t* smem) {
  *smem = smem_bytes_scratch(K, NW);
  if (*smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(fused_st_scratch_kernel<DIN, NW>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <int DIN, int NW>
int scratch_blocks(int K, int* blocks) {
  size_t smem;
  int e = scratch_attrs<DIN, NW>(K, &smem);
  if (e != 0) return e;
  int dev, sms, per_sm;
  if ((e = (int)cudaGetDevice(&dev)) != 0) return e;
  if ((e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0) return e;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_st_scratch_kernel<DIN, NW>, NW * 32, smem);
  if (e != 0) return e;
  *blocks = sms * per_sm;
  return 0;
}

template <int DIN, int NW>
int launch_scratch(const void* points, int points_bf16, const uint8_t* mask, const uint8_t* cm,
                   const bf16* wb, const float* wf, float* out, int N, int K, int M, int ncls,
                   int grid, uint4* scratch, cudaStream_t stream) {
  size_t smem;
  const int e = scratch_attrs<DIN, NW>(K, &smem);
  if (e != 0) return e;
  fused_st_scratch_kernel<DIN, NW><<<grid, NW * 32, smem, stream>>>(
      points, points_bf16, mask, cm, wb, wf, out, N, K, M, ncls, scratch);
  return (int)cudaGetLastError();
}

constexpr int kMaxScratchPoints = 65536;   // the scratch form's limit

}  // namespace

// The scratch form's limit on the points of a cloud: 0 if M is outside
// 1 .. 128.  Its blocks keep the points' flags (Kp bytes) in shared memory.
extern "C" int pcaudio_fused_st_scratch_max_points(int M) {
  return M < 1 || M > 128 ? 0 : kMaxScratchPoints;
}

// Blocks of the scratch form resident on the device at once for (din, M, K).
extern "C" int pcaudio_fused_st_scratch_blocks(int din, int M, int K, int* blocks) {
  if (K < 1 || K > pcaudio_fused_st_scratch_max_points(M) || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool wide = M > 64;
  if (din == 2) return wide ? scratch_blocks<2, 8>(K, blocks) : scratch_blocks<2, 4>(K, blocks);
  if (din == 3) return wide ? scratch_blocks<3, 8>(K, blocks) : scratch_blocks<3, 4>(K, blocks);
  return (int)cudaErrorInvalidValue;
}

// The scratch form on `grid` blocks; scratch holds n_scratch bf16, at least
// grid slabs of Kp x 64 (Kp: K rounded up to 16 x warps).  mask and
// cloud_mask as pcaudio_fused_st's.
extern "C" int pcaudio_fused_st_scratch(const void* points, int points_bf16, const void* mask,
                                        const void* cloud_mask, const void* wb,
                                        long long n_bf16, const void* wf, long long n_f32,
                                        void* out, int N, int K, int din, int M, int ncls,
                                        int grid, void* scratch, long long n_scratch,
                                        void* stream) {
  if (N < 1 || K < 1 || ncls < 1 || ncls > 256 || grid < 1 || scratch == nullptr ||
      (mask != nullptr && cloud_mask != nullptr) || K > pcaudio_fused_st_scratch_max_points(M))
    return (int)cudaErrorInvalidValue;
  if (n_bf16 != packed_bf16(din, M, ncls) || n_f32 != packed_f32(M, ncls))
    return (int)cudaErrorInvalidValue;
  const bool wide = M > 64;
  if ((long long)grid * (long long)slab_uint4(K, wide ? 8 : 4) * 8 > n_scratch)
    return (int)cudaErrorInvalidValue;
  const auto m = (const uint8_t*)mask;
  const auto cm = (const uint8_t*)cloud_mask;
  const auto b = (const bf16*)wb;
  const auto f = (const float*)wf;
  const auto st = (cudaStream_t)stream;
  const auto x = (uint4*)scratch;
  if (din == 2) {
    return wide ? launch_scratch<2, 8>(points, points_bf16, m, cm, b, f, (float*)out, N, K, M, ncls, grid, x, st)
                : launch_scratch<2, 4>(points, points_bf16, m, cm, b, f, (float*)out, N, K, M, ncls, grid, x, st);
  }
  if (din == 3) {
    return wide ? launch_scratch<3, 8>(points, points_bf16, m, cm, b, f, (float*)out, N, K, M, ncls, grid, x, st)
                : launch_scratch<3, 4>(points, points_bf16, m, cm, b, f, (float*)out, N, K, M, ncls, grid, x, st);
  }
  return (int)cudaErrorInvalidValue;
}
