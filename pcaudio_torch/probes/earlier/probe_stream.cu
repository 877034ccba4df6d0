// The SIMT design of csrc/probe_stream.cu before its gram kernel's redesign (git a0f098b),
// kept verbatim below so that probes/probe_stages.py and chip_smoke.py phase 8 can
// build it as its own library and time its int16 gram beside the redesign in one process.
// Streaming probe kernels: the H100 counterparts of the TPU timing probes
// behind K3's input and relayout questions.
//
//   int16_gram_kernel  P6a scripts/probe_int16_load.py:18 (`kern`): int16
//                      rows -> f32 * (1/32768), then x . x^T, [n, L] -> [n, n];
//   wave_sums_kernel   P6b scripts/probe_int16_load.py:38 (`kern2`): one f32
//                      sum per [rows, L] wave block, int16 or f32 in;
//   relayout_kernel    P7 scripts/probe_chunk_relayout.py:26 (`k_pass`), :29
//                      (`k_reshape`): x + 1 over [B, C*Nt, F], written as
//                      frame rows or as [B, C, Nt*F/128, 128] lane blocks.
//
// What bounds them on the H100: device memory (3.35 TB/s) for the sweep and
// the relayout, which read every byte once and do one add per element;
// the host's launch for the 64 x 64 gram (4 MFLOP).  The design follows:
// 16-byte loads, neighbouring threads on neighbouring addresses, several
// loads in flight per thread, one block per wave for the sweep (no atomics:
// the script writes one sum per block).  The relayout's reshape is the
// identity on the bytes of a row-major tensor; its kernel computes each
// source index from the output's [C, nb, 128] index with integer division
// by the runtime widths, so it measures that index arithmetic against the
// pass-through.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace pcaudio;

constexpr int kGramThreads = 64;
constexpr float kPcmScale = 1.0f / 32768.0f;  // exact: a power of two

__global__ void __launch_bounds__(kGramThreads)
int16_gram_kernel(const int16_t* __restrict__ x, float* __restrict__ out, int n, int L) {
  extern __shared__ float xi[];  // row blockIdx.x, converted
  const int i = blockIdx.x;
  for (int k = threadIdx.x; k < L; k += kGramThreads)
    xi[k] = (float)x[(long long)i * L + k] * kPcmScale;
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kGramThreads) {
    const int16_t* xj = x + (long long)j * L;
    float acc = 0.f;
    for (int k = 0; k < L; ++k) acc = fmaf(xi[k], (float)xj[k] * kPcmScale, acc);
    out[(long long)i * n + j] = acc;
  }
}

constexpr int kSumThreads = 256;
constexpr int kSumUnroll = 4;  // 16-byte loads in flight per thread

__device__ __forceinline__ float sum16(const uint4& v, bool int16) {
  if (int16) {
    const int16_t* h = reinterpret_cast<const int16_t*>(&v);
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) s += (float)h[e];
    return s;
  }
  const float* f = reinterpret_cast<const float*>(&v);
  return (f[0] + f[1]) + (f[2] + f[3]);
}

template <bool Int16>
__global__ void __launch_bounds__(kSumThreads)
wave_sums_kernel(const uint4* __restrict__ x, float* __restrict__ out, long long vecs) {
  __shared__ float buf[32];
  const uint4* xc = x + blockIdx.x * vecs;
  float s = 0.f;
  long long v = threadIdx.x;
  for (; v + (kSumUnroll - 1) * kSumThreads < vecs; v += kSumUnroll * kSumThreads) {
    uint4 r[kSumUnroll];
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) r[u] = xc[v + u * kSumThreads];
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) s += sum16(r[u], Int16);
  }
  for (; v < vecs; v += kSumThreads) s += sum16(xc[v], Int16);
  s = block_sum(s, buf);
  if (threadIdx.x == 0) {
    out[2 * blockIdx.x] = s;
    out[2 * blockIdx.x + 1] = 0.f;
  }
}

constexpr int kRelayoutThreads = 256;

// One float4 a thread, blockIdx.y the clip; offsets within a clip are
// 32-bit (C*Nt*F < 2^31).
template <bool Reshape>
__global__ void __launch_bounds__(kRelayoutThreads)
relayout_kernel(const float4* __restrict__ x, float4* __restrict__ out, int per4, int C,
                int nb, int F) {
  const int o = blockIdx.x * kRelayoutThreads + threadIdx.x;  // float4 in the clip
  if (o >= per4) return;
  int src = o;
  if (Reshape) {  // out [C][nb][128] -> x [C*Nt][F]
    const int e = o * 4, l = e % 128, rest = e / 128;
    const int q = rest % nb, c = (rest / nb) % C;
    const int flat = (c * nb + q) * 128 + l;
    src = ((flat / F) * F + flat % F) / 4;
  }
  const long long base = (long long)blockIdx.y * per4;
  float4 v = x[base + src];
  v.x += 1.f;
  v.y += 1.f;
  v.z += 1.f;
  v.w += 1.f;
  out[base + o] = v;
}

}  // namespace

// x [n][L] int16, out [n][n] f32.  L <= 4096 (one row in shared memory).
extern "C" int pcaudio_probe_int16_gram(const void* x, void* out, int n, int L,
                                        void* stream) {
  if (n < 1 || L < 1 || L > 4096) return (int)cudaErrorInvalidValue;
  int16_gram_kernel<<<n, kGramThreads, L * sizeof(float), (cudaStream_t)stream>>>(
      (const int16_t*)x, (float*)out, n, L);
  return (int)cudaGetLastError();
}

// x [n][per] int16 (int16 != 0) or f32, per * element size a multiple of 16
// bytes, 16-byte aligned; out [n][2] f32: (sum of block c, 0).
extern "C" int pcaudio_probe_wave_sums(const void* x, void* out, int n, int per, int int16,
                                       void* stream) {
  const long long bytes = (long long)per * (int16 ? 2 : 4);
  if (n < 1 || per < 1 || bytes % 16 || (uintptr_t)x % 16) return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  if (int16)
    wave_sums_kernel<true><<<n, kSumThreads, 0, st>>>((const uint4*)x, (float*)out, bytes / 16);
  else
    wave_sums_kernel<false><<<n, kSumThreads, 0, st>>>((const uint4*)x, (float*)out, bytes / 16);
  return (int)cudaGetLastError();
}

// x [B][C*Nt][F] f32, out x + 1 as [B][C*Nt][F] (reshape == 0) or
// [B][C][Nt*F/128][128].  F a multiple of 4, Nt*F of 128, both 16-byte
// aligned.
extern "C" int pcaudio_probe_relayout(const void* x, void* out, int B, int C, int Nt, int F,
                                      int reshape, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || Nt < 1 || F < 4 || F % 4 || (Nt * F) % 128 ||
      (long long)C * Nt * F >= (1LL << 31) || ((uintptr_t)x | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  const int per4 = C * Nt * F / 4;
  const dim3 grid((per4 + kRelayoutThreads - 1) / kRelayoutThreads, B);
  const auto st = (cudaStream_t)stream;
  if (reshape)
    relayout_kernel<true><<<grid, kRelayoutThreads, 0, st>>>((const float4*)x, (float4*)out,
                                                             per4, C, Nt * F / 128, F);
  else
    relayout_kernel<false><<<grid, kRelayoutThreads, 0, st>>>((const float4*)x, (float4*)out,
                                                              per4, C, Nt * F / 128, F);
  return (int)cudaGetLastError();
}
