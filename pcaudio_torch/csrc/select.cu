// Kernel K2: exact per-chunk top-K of non-negative magnitudes.
//
// Replaces the Pallas kernel pcaudio/ops/kernels/select.py::
// exact_topk_chunks (`_kernel` with `_compact_gather` or the one-hot
// scatter).  One block per chunk:
//
//  1. load the chunk's Nt*F values into shared memory as uint32 keys (the
//     f32 bit pattern; a bf16 value is its top 16 bits), which order like
//     the values because the values are non-negative;
//  2. radix select over 8-bit digits, most significant first (4 passes for
//     f32, 2 for bf16, whose low 16 bits are zero): per pass a shared
//     histogram of the keys that match the digits found so far, and one warp
//     that finds the digit holding the K-th largest key -> the exact K-th
//     largest key tau and `need`, how many keys equal to tau are taken;
//  3. winners are the keys > tau plus the first `need` keys == tau in flat
//     order (a block prefix scan over tie counts), which is lax.top_k's
//     take-first-on-ties set;
//  4. each winner's value and flat index go to its exclusive-scan position:
//     ascending flat-index order, as the JAX kernel returns them.
//
// The JAX kernel's threshold search floors at 2^-126, so its tie cut can
// differ from lax.top_k's when the K-th value is subnormal; comparing bit
// patterns here is exact for subnormals too.
//
// What bounds it on the H100: the chunk is read once (10 KB for a bf16
// 10 x 512 chunk) and K (value, index) pairs written; all passes run in
// shared memory.  Work per chunk is a few passes over 5,120 keys, so the
// kernel is bounded by shared-memory atomics and block synchronisations,
// not by HBM; several chunks' blocks share each SM to hide them.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kSelectThreads = 256;

__global__ void __launch_bounds__(kSelectThreads)
topk_chunks_kernel(const void* __restrict__ mags, int mags_bf16, int L, int K,
                   float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned keys[];  // [L]
  __shared__ int hist[256];
  __shared__ int scan_buf[32];
  __shared__ unsigned s_prefix;
  __shared__ int s_krem;

  const size_t base = (size_t)blockIdx.x * L;
  if (mags_bf16) {
    const unsigned short* src = reinterpret_cast<const unsigned short*>(mags) + base;
    for (int i = threadIdx.x; i < L; i += blockDim.x) keys[i] = (unsigned)src[i] << 16;
  } else {
    const unsigned* src = reinterpret_cast<const unsigned*>(mags) + base;
    for (int i = threadIdx.x; i < L; i += blockDim.x) keys[i] = src[i];
  }

  unsigned prefix = 0, known = 0;  // digits found so far, and their bits
  int krem = K;                    // rank of tau among the keys matching prefix
  const int last_shift = mags_bf16 ? 16 : 0;
  for (int shift = 24; shift >= last_shift; shift -= 8) {
    for (int d = threadIdx.x; d < 256; d += blockDim.x) hist[d] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      const unsigned k = keys[i];
      if ((k & known) == prefix) atomicAdd(&hist[(k >> shift) & 255u], 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l holds digits 255 - 8l down to 248 - 8l: count from the top
      const int lane = threadIdx.x;
      int local = 0;
      for (int j = 0; j < 8; ++j) local += hist[255 - 8 * lane - j];
      int incl = local;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(pcaudio::kFullMask, incl, o);
        if (lane >= o) incl += y;
      }
      int above = incl - local;  // keys with a larger digit than my first
      if (above < krem && krem <= incl) {
        for (int j = 0; j < 8; ++j) {
          const int d = 255 - 8 * lane - j;
          if (above + hist[d] >= krem) {
            s_prefix = prefix | ((unsigned)d << shift);
            s_krem = krem - above;
            break;
          }
          above += hist[d];
        }
      }
    }
    __syncthreads();
    prefix = s_prefix;
    krem = s_krem;
    known |= 255u << shift;
  }
  const unsigned tau = prefix;
  const int need = krem;  // keys == tau to take; keys > tau number K - need

  // contiguous flat ranges per thread keep flat order across the scans
  const int per = (L + blockDim.x - 1) / blockDim.x;
  const int lo = min(L, (int)threadIdx.x * per), hi = min(L, lo + per);
  int ties = 0;
  for (int i = lo; i < hi; ++i) ties += keys[i] == tau;
  int total;
  const int tie0 = pcaudio::block_exclusive_scan(ties, scan_buf, &total);
  int wins = 0, tr = tie0;
  for (int i = lo; i < hi; ++i) {
    const unsigned k = keys[i];
    if (k > tau) {
      ++wins;
    } else if (k == tau) {
      wins += tr < need;
      ++tr;
    }
  }
  int pos = pcaudio::block_exclusive_scan(wins, scan_buf, &total);
  float* ov = out_v + (size_t)blockIdx.x * K;
  int* oi = out_i + (size_t)blockIdx.x * K;
  tr = tie0;
  for (int i = lo; i < hi; ++i) {
    const unsigned k = keys[i];
    bool win = k > tau;
    if (k == tau) win = tr++ < need;
    if (win) {
      ov[pos] = __uint_as_float(k);
      oi[pos] = i;
      ++pos;
    }
  }
}

}  // namespace

extern "C" int pcaudio_topk_chunks(const void* mags, int mags_bf16, void* vals,
                                   void* idx, int N, int L, int K, void* stream) {
  if (N < 1 || K < 1 || K > L) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)L * sizeof(unsigned);
  if (smem > 227 * 1024 - 2048) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 - 2048) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_chunks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  topk_chunks_kernel<<<N, kSelectThreads, smem, (cudaStream_t)stream>>>(
      mags, mags_bf16, L, K, (float*)vals, (int*)idx);
  return (int)cudaGetLastError();
}
