// Shared helpers of the pcaudio_torch kernels: block reductions and scans.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace pcaudio {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Sum over the block; every thread gets the total.  `buf` holds >= 32
// floats of shared memory.  Must be reached by all threads of the block.
__device__ __forceinline__ float block_sum(float v, float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? buf[lane] : 0.f;
  t = warp_sum(t);
  return t;
}

__device__ __forceinline__ float block_max(float v, float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? buf[lane] : -INFINITY;
  return warp_max(t);
}

// Exclusive prefix sum over the block in thread order; `*total` gets the
// block total.  `buf` holds >= 32 ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* buf, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? buf[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, w, o);
      if (lane >= o) w += y;
    }
    buf[lane] = w;
  }
  __syncthreads();
  *total = buf[nwarps - 1];
  return x - v + (warp > 0 ? buf[warp - 1] : 0);
}

}  // namespace pcaudio
