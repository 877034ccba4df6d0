// Kernel K3: waveform -> trimmed, reflect-padded STFT |X|^2 chunks.
//
// Replaces the Pallas kernel pcaudio/ops/kernels/featurize.py::
// fused_chunk_mag2 (`_kernel`).  Two launches:
//
//  1. trim_bounds_kernel, one block per clip: librosa effects.trim(top_db)
//     bounds from 512-sample block energies, the centered 2048-sample frame
//     powers with their left and right reflect corrections (the same terms
//     as pcaudio/dsp/trim.py), the max-referenced dB, and the first and last
//     non-silent frame -> (start, tlen) per clip.
//  2. chunk_mag2_kernel, a block per (clip, 4 frames): each frame of the
//     trimmed signal y = x[start, start + tlen) with center=True reflect
//     padding by 512 (single bounce across both trim edges), the periodic
//     Hann window, an in-shared-memory radix-2 f32 FFT of 1024 points, and
//     |X|^2 of bins 0..511 (Nyquist dropped), stored as [B, C*Nt, 512] in
//     f32 or bf16 (rounded only at the store).
//
// What bounds it on the H100: the wave is read twice (once per launch) and
// the grid written once, 2 x 0.9 MB + 0.44 MB (bf16) per 5 s clip, about
// 0.7 ms of HBM time per 1024 clips at 3.35 TB/s.  The FFT does
// 5 * 1024 * 10 flops per frame; the TPU kernel instead multiplied each
// frame by a [1024, 1024] DFT basis (2 * 1024^2 flops per frame) because
// its matrix unit made that cheap.  Here the butterflies' shared-memory
// traffic (five 8-byte accesses per butterfly) is the larger cost; the
// design keeps the whole frame on chip and reads each sample from HBM once
// per launch.  The TPU kernel's one-hot row selections and reflect maps
// become plain index arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kNfft = 1024;
constexpr int kHop = 512;           // STFT hop == trim detector hop at n_fft 1024
constexpr int kTrimFrame = 2048;    // librosa trim frame_length
constexpr float kAmin = 1.0e-10f;   // librosa power_to_db floor
constexpr int kTrimThreads = 512;
constexpr int kFramesPerBlock = 4;
constexpr int kFrameThreads = 256;

__global__ void __launch_bounds__(kTrimThreads)
trim_bounds_kernel(const float* __restrict__ waves,
                   const int* __restrict__ lengths, int* __restrict__ info,
                   int L, int trim, float top_db) {
  extern __shared__ float sm[];  // eb [T + 1] then mse [T]
  __shared__ float red[32];
  __shared__ float s_right[8];
  __shared__ float s_left[2];
  __shared__ int s_first, s_last;

  const int b = blockIdx.x;
  const float* x = waves + (size_t)b * L;
  const int length = min(max(lengths[b], 0), L);
  if (!trim) {
    if (threadIdx.x == 0) {
      info[2 * b] = 0;
      info[2 * b + 1] = length;
    }
    return;
  }
  const int T = 1 + L / kHop;
  const int NB = T + 1;  // frame t sums blocks t-2 .. t+1
  float* eb = sm;
  float* mse = sm + NB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // block energies of the valid samples, one warp per block
  for (int r = warp; r < NB; r += nwarps) {
    float acc = 0.f;
    for (int i = lane; i < kHop; i += 32) {
      const int s = r * kHop + i;
      if (s < length) acc = fmaf(x[s], x[s], acc);
    }
    acc = pcaudio::warp_sum(acc);
    if (lane == 0) eb[r] = acc;
  }
  if (threadIdx.x == 0) {
    s_first = T;
    s_last = -1;
  }

  // right reflect: frames with a < length < b mirror the w = b - length
  // samples ending at length - 2 (at most 4 frames)
  const int t_lo = length >= kTrimFrame / 2 ? (length - kTrimFrame / 2) / kHop + 1 : 0;
  const int t_hi = min((length + kTrimFrame / 2 - 1) / kHop, T - 1);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int fb = t * kHop + kTrimFrame / 2;
    const int w = min(fb - length, kTrimFrame);
    const int lo = max(0, length - 1 - w), hi = max(0, length - 1);
    float part = 0.f;
    for (int s = lo + threadIdx.x; s < hi; s += blockDim.x) part = fmaf(x[s], x[s], part);
    const float tot = pcaudio::block_sum(part, red);
    if (threadIdx.x == 0) s_right[t - t_lo] = tot;
  }
  __syncthreads();

  // left reflect: frame 2 - j mirrors samples [1, j * 512]
  if (threadIdx.x == 0) {
    const float x0sq = length > 0 ? x[0] * x[0] : 0.f;
    for (int j = 1; j <= 2; ++j) {
      float span = 0.f;
      for (int i = 0; i < j; ++i) span += eb[i];
      const float nxt = j * kHop < length ? x[j * kHop] * x[j * kHop] : 0.f;
      s_left[2 - j] = length > 0 ? span - x0sq + nxt : 0.f;
    }
  }
  __syncthreads();

  const int n_valid = 1 + length / kHop;
  float mx = 0.f;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float main = 0.f;
    for (int i = -2; i < 2; ++i) main += (t + i >= 0) ? eb[t + i] : 0.f;
    const float left = t < 2 ? s_left[t] : 0.f;
    const float right = (t >= t_lo && t <= t_hi) ? s_right[t - t_lo] : 0.f;
    const float m = (main + left + right) / (float)kTrimFrame;
    mse[t] = m;
    if (t < n_valid) mx = fmaxf(mx, m);
  }
  const float ref = fmaxf(pcaudio::block_max(mx, red), kAmin);
  const float lref = log10f(ref);
  for (int t = threadIdx.x; t < n_valid && t < T; t += blockDim.x) {
    const float db = 10.f * (log10f(fmaxf(mse[t], kAmin)) - lref);
    if (db > -top_db) {
      atomicMin(&s_first, t);
      atomicMax(&s_last, t);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool any = s_last >= 0;
    const int start = any ? s_first * kHop : 0;
    const int end = any ? min(length, (s_last + 1) * kHop) : 0;
    info[2 * b] = start;
    info[2 * b + 1] = end - start;
  }
}

__device__ __forceinline__ int bitrev10(int v) { return (int)(__brev((unsigned)v) >> 22); }

__global__ void __launch_bounds__(kFrameThreads)
chunk_mag2_kernel(const float* __restrict__ waves, const int* __restrict__ info,
                  void* __restrict__ out, int out_bf16, int L, int n_frames) {
  __shared__ float2 buf[kFramesPerBlock * kNfft];
  __shared__ float2 tw[kNfft / 2];

  const int fblocks = (n_frames + kFramesPerBlock - 1) / kFramesPerBlock;
  const int b = blockIdx.x / fblocks;
  const int t0 = (blockIdx.x % fblocks) * kFramesPerBlock;
  const int start = info[2 * b], tlen = info[2 * b + 1];
  const float* y = waves + (size_t)b * L + start;

  for (int k = threadIdx.x; k < kNfft / 2; k += blockDim.x) {
    float s, c;
    sincospif((float)k / (kNfft / 2), &s, &c);  // angle 2*pi*k/1024
    tw[k] = make_float2(c, -s);
  }
  // windowed frames, bit-reversed for the in-place DIT transform
  for (int e = threadIdx.x; e < kFramesPerBlock * kNfft; e += blockDim.x) {
    const int f = e / kNfft, j = e % kNfft, t = t0 + f;
    float v = 0.f;
    if (t < n_frames && tlen > 0) {
      int p = t * kHop - kNfft / 2 + j;
      if (p < 0) p = -p;
      if (p >= tlen) p = 2 * tlen - 2 - p;
      p = min(max(p, 0), tlen - 1);
      v = y[p] * (0.5f - 0.5f * cospif((float)j / (kNfft / 2)));
    }
    buf[f * kNfft + bitrev10(j)] = make_float2(v, 0.f);
  }
  __syncthreads();

  for (int half = 1; half < kNfft; half <<= 1) {
    const int tstride = (kNfft / 2) / half;
    for (int e = threadIdx.x; e < kFramesPerBlock * (kNfft / 2); e += blockDim.x) {
      const int f = e / (kNfft / 2), bi = e % (kNfft / 2);
      const int pos = bi & (half - 1);
      const int i0 = ((bi - pos) << 1) + pos, i1 = i0 + half;
      float2* row = buf + f * kNfft;
      const float2 w = tw[pos * tstride];
      const float2 u = row[i0], q = row[i1];
      const float2 v = make_float2(q.x * w.x - q.y * w.y, q.x * w.y + q.y * w.x);
      row[i0] = make_float2(u.x + v.x, u.y + v.y);
      row[i1] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < kFramesPerBlock * (kNfft / 2); e += blockDim.x) {
    const int f = e / (kNfft / 2), k = e % (kNfft / 2), t = t0 + f;
    if (t >= n_frames) continue;
    const float2 X = buf[f * kNfft + k];
    const float m2 = X.x * X.x + X.y * X.y;
    const size_t o = ((size_t)b * n_frames + t) * (kNfft / 2) + k;
    if (out_bf16) {
      reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(m2);
    } else {
      reinterpret_cast<float*>(out)[o] = m2;
    }
  }
}

}  // namespace

extern "C" {

int pcaudio_trim_bounds(const void* waves, const void* lengths, void* info,
                        int B, int L, int trim, float top_db, void* stream) {
  if (B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const int T = 1 + L / kHop;
  const size_t smem = (size_t)(2 * T + 1) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trim_bounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  trim_bounds_kernel<<<B, kTrimThreads, smem, (cudaStream_t)stream>>>(
      (const float*)waves, (const int*)lengths, (int*)info, L, trim, top_db);
  return (int)cudaGetLastError();
}

int pcaudio_chunk_mag2(const void* waves, const void* info, void* out,
                       int out_bf16, int B, int L, int n_frames, void* stream) {
  if (B < 1 || L < 1 || n_frames < 1) return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)B * ((n_frames + kFramesPerBlock - 1) / kFramesPerBlock);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  chunk_mag2_kernel<<<(unsigned)blocks, kFrameThreads, 0, (cudaStream_t)stream>>>(
      (const float*)waves, (const int*)info, out, out_bf16, L, n_frames);
  return (int)cudaGetLastError();
}

const char* pcaudio_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
