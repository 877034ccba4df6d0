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
//  2. frames_mag2_kernel, a block per (clip, run of kRun frames): each frame
//     of the trimmed signal y = x[start, start + tlen) with center=True
//     reflect padding by 512 (single bounce across both trim edges), the
//     periodic Hann window, a 1024-point real f32 FFT, and |X|^2 of bins
//     0..511 (Nyquist dropped), stored as [B, C*Nt, 512] in f32 or bf16
//     (rounded only at the store).
//
// What bounds it on the H100: bytes.  The waves are read once by each
// launch and the grid written once: 904 MB in and 451 MB of bf16 out at the
// bench shape (1024 clips of 220,672 samples, 430 frames), 0.404 ms at
// 3.35 TB/s, or about 0.67 ms with the trim pass's own read of the waves.
// The transform is 2.5 * 1024 * 10 f32 operations a frame, halved by the
// real-input form: 5.6 GFLOP, 0.08 ms at 67 TFLOP/s.  The TPU kernel
// multiplied each frame by a [1024, 1024] DFT basis because its matrix unit
// made that cheap; on this card the FFT is the right algorithm.
//
// The frame pass is built on one fact: the trim start is s0 * 512, a
// multiple of the hop (trim_bounds_kernel).  So frame t of the trimmed
// signal, for 1 <= t < t_last = tlen / 512, is exactly the raw window
// x[start + (t-1)*512, start + (t+1)*512): 16-byte aligned, inside the clip,
// no reflection.  Only frame 0 (left reflect) and frame t_last (right
// reflect) of a clip take the reflect index map; frames past t_last lie in
// no valid chunk and only have to be finite.  Those take a slow path that
// reads each sample through the index map, clamped into the clip.
//
// What the design does about the five costs of the previous radix-2 form:
//  - each sample read 1.6 times: a block loads the (n + 1) * 512 distinct
//    samples of its n fast frames once, with 16-byte loads, into shared
//    memory, where the frames overlap;
//  - per-sample transcendentals: the window and every twiddle come from
//    tables that each block computes once with cospif / sincospif (full
//    precision; the build has no fast-math);
//  - half the work thrown away: real-input form.  A frame's even and odd
//    samples make one 512-point complex sequence z[n] = x[2n] + i x[2n+1],
//    Z = FFT512(z), and X[k] = (Z[k] + conj Z[-k]) / 2 + W1024^k (Z[k] -
//    conj Z[-k]) / 2i.  This form, and not two frames packed into one
//    1024-point transform, because a frame's rounding then never reaches
//    another frame: a silent frame beside a loud one stays exactly 0, as in
//    the plain version, whatever chunk boundary falls between them;
//  - ten shared-memory passes and ten block barriers a frame: 64 threads
//    (one group) own a frame, each holding 8 complex points in registers,
//    and the 512 points go through three radix-8 passes (512 = 8 * 8 * 8,
//    four-step order) with two exchanges through shared memory and one to
//    pair bin k with bin 512 - k, synchronised by the group's own named
//    barrier, so the block's four groups never wait on each other;
//  - bank conflicts: every exchange layout is padded (rows of 72) or XOR
//    swizzled so that each warp's stores and loads of one instruction hit 32
//    distinct banks (the index maps are spelled out at each pass), and each
//    twiddle table is laid out in the order its pass reads it, so lanes
//    read consecutive words.
// The epilogue forms |X|^2 in registers and stores 8 consecutive bins a
// thread (16 bytes in bf16), so a warp writes half a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kNfft = 1024;
constexpr int kHop = 512;           // STFT hop == trim detector hop at n_fft 1024
constexpr int kTrimFrame = 2048;    // librosa trim frame_length
constexpr float kAmin = 1.0e-10f;   // librosa power_to_db floor
constexpr int kTrimThreads = 512;

constexpr int kRun = 16;            // frames a block
constexpr int kGroupThreads = 64;   // threads a frame: 512 points, 8 each
constexpr int kGroups = 4;
constexpr int kFrameThreads = kGroups * kGroupThreads;
constexpr int kRow = 72;            // padded row of an 8 x 64 exchange
constexpr int kXch = 7 * kRow + 64; // one exchange buffer, re or im
// shared memory of the frame pass, in floats: staged samples, window,
// pass-1 / pass-2 / epilogue twiddles (re, im), the groups' exchanges
constexpr int kStage = (kRun + 1) * kHop;
constexpr int kSmemFloats =
    kStage + kNfft + 2 * 512 + 2 * 64 + 2 * 512 + kGroups * 2 * kXch;

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

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float re, float im) {
  return make_float2(a.x * re - a.y * im, a.x * im + a.y * re);
}
__device__ __forceinline__ float2 neg_i(float2 a) { return make_float2(a.y, -a.x); }

// In-register 8-point DFT, X[k] = sum_n a[n] exp(-2 pi i n k / 8): radix-2
// decimation in frequency, outputs put back in natural order.
__device__ __forceinline__ void dft8(float2 (&a)[8]) {
  constexpr float r = 0.70710678118654752f;
  const float2 b0 = cadd(a[0], a[4]), b1 = cadd(a[1], a[5]);
  const float2 b2 = cadd(a[2], a[6]), b3 = cadd(a[3], a[7]);
  const float2 b4 = csub(a[0], a[4]);
  const float2 d5 = csub(a[1], a[5]);
  const float2 b5 = make_float2(r * (d5.x + d5.y), r * (d5.y - d5.x));   // * W8
  const float2 b6 = neg_i(csub(a[2], a[6]));                             // * W8^2
  const float2 d7 = csub(a[3], a[7]);
  const float2 b7 = make_float2(r * (d7.y - d7.x), -r * (d7.x + d7.y));  // * W8^3
  const float2 c0 = cadd(b0, b2), c1 = cadd(b1, b3);
  const float2 c2 = csub(b0, b2), c3 = neg_i(csub(b1, b3));
  const float2 c4 = cadd(b4, b6), c5 = cadd(b5, b7);
  const float2 c6 = csub(b4, b6), c7 = neg_i(csub(b5, b7));
  a[0] = cadd(c0, c1);
  a[4] = csub(c0, c1);
  a[2] = cadd(c2, c3);
  a[6] = csub(c2, c3);
  a[1] = cadd(c4, c5);
  a[5] = csub(c4, c5);
  a[3] = cadd(c6, c7);
  a[7] = csub(c6, c7);
}

// Barrier of one 64-thread group (ids 1..kGroups; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kGroupThreads) : "memory");
}

// Position of Z[k] in the epilogue exchange: the low 3 bits XOR (k >> 5) & 7,
// so that both pass 3's stores and the epilogue's loads of Z[8u + i] and
// Z[512 - 8u - i] (u = lane, i fixed) fall in 32 distinct banks.
__device__ __forceinline__ int zpos(int k) { return (k & ~7) | ((k & 7) ^ ((k >> 5) & 7)); }

__global__ void __launch_bounds__(kFrameThreads, 3)
frames_mag2_kernel(const float* __restrict__ waves, const int* __restrict__ info,
                   void* __restrict__ out, int out_bf16, int L, int n_frames,
                   int vec) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                    // y[(t0 - 1) * 512 + s] at s
  float* win = stage + kStage;            // periodic Hann, 1024
  float* p1re = win + kNfft;              // [m'][j] = W512^(j m')
  float* p1im = p1re + 512;
  float* p2re = p1im + 512;               // [r][j0] = W64^(j0 r)
  float* p2im = p2re + 64;
  float* tpre = p2im + 64;                // [i][u] = W1024^(8u + i)
  float* tpim = tpre + 512;
  float* xch = tpim + 512;                // per group: re [kXch], im [kXch]

  const int runs = (n_frames + kRun - 1) / kRun;
  const int b = blockIdx.x / runs;
  const int t0 = (blockIdx.x % runs) * kRun;
  const int t_end = min(t0 + kRun, n_frames);
  const int start = info[2 * b], tlen = info[2 * b + 1];
  const int t_last = tlen / kHop;
  const float* y = waves + (size_t)b * L + start;
  const int tid = threadIdx.x;

  for (int i = tid; i < kNfft; i += kFrameThreads)
    win[i] = 0.5f - 0.5f * cospif((float)i / (kNfft / 2));
  for (int e = tid; e < 512; e += kFrameThreads) {
    float s, c;
    sincospif((float)(((e >> 6) * (e & 63)) & 511) / 256.f, &s, &c);
    p1re[e] = c;
    p1im[e] = -s;
    sincospif((float)(8 * (e & 63) + (e >> 6)) / 512.f, &s, &c);
    tpre[e] = c;
    tpim[e] = -s;
  }
  if (tid < 64) {
    float s, c;
    sincospif((float)(((tid >> 3) * (tid & 7)) & 63) / 32.f, &s, &c);
    p2re[tid] = c;
    p2im[tid] = -s;
  }
  // the fast frames [f_lo, f_hi) read y[(f_lo - 1) * 512, f_hi * 512), all
  // inside [0, tlen): staged once, with 16-byte loads where aligned
  const int f_lo = max(t0, 1), f_hi = min(t_end, t_last);
  if (f_lo < f_hi) {
    const float* src = y + (size_t)(f_lo - 1) * kHop;
    float* dst = stage + (f_lo - t0) * kHop;
    const int n = (f_hi - f_lo + 1) * kHop;
    if (vec) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int v = tid; v < n / 4; v += kFrameThreads) d4[v] = __ldg(s4 + v);
    } else {
      for (int v = tid; v < n; v += kFrameThreads) dst[v] = __ldg(src + v);
    }
  }
  __syncthreads();

  const int g = tid / kGroupThreads, gt = tid % kGroupThreads;
  float* xr = xch + g * 2 * kXch;
  float* xi = xr + kXch;
  for (int t = t0 + g; t < t_end; t += kGroups) {
    const size_t o = ((size_t)b * n_frames + t) * (kNfft / 2) + 8 * gt;
    float m2[8];
    if (tlen > 0) {
      // z[n] = x[2n] + i x[2n+1], windowed; thread j holds n = j + 64 m
      float2 a[8];
      if (t >= f_lo && t < f_hi) {
        const float* fr = stage + (t - t0) * kHop;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int n2 = 2 * (gt + 64 * m);
          const float2 s = *reinterpret_cast<const float2*>(fr + n2);
          const float2 w = *reinterpret_cast<const float2*>(win + n2);
          a[m] = make_float2(s.x * w.x, s.y * w.y);
        }
      } else {
        // frame 0, t_last and beyond: the reflect map of dsp/stft.py,
        // clamped into [0, tlen)
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int n2 = 2 * (gt + 64 * m);
          float v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int p = t * kHop - kNfft / 2 + n2 + h;
            if (p < 0) p = -p;
            if (p >= tlen) p = 2 * tlen - 2 - p;
            p = min(max(p, 0), tlen - 1);
            v[h] = __ldg(y + p) * win[n2 + h];
          }
          a[m] = make_float2(v[0], v[1]);
        }
      }
      // pass 1: DFT over m -> m', twiddle W512^(j m'); stored [m'][j] in
      // rows of 72 (a warp's lanes are 32 consecutive j: distinct banks)
      dft8(a);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        if (m > 0) a[m] = cmul(a[m], p1re[m * 64 + gt], p1im[m * 64 + gt]);
        xr[m * kRow + gt] = a[m].x;
        xi[m * kRow + gt] = a[m].y;
      }
      group_sync(g);
      // pass 2: thread (j0, m') = (gt & 7, gt >> 3) takes j = j0 + 8 j1
      // (bank 8 (m' + j1) + j0 mod 32: distinct over a warp's j0, m'),
      // DFT over j1 -> r, twiddle W64^(j0 r)
      {
        const int j0 = gt & 7, mp = gt >> 3;
#pragma unroll
        for (int j1 = 0; j1 < 8; ++j1) {
          const int idx = mp * kRow + 8 * j1 + j0;
          a[j1] = make_float2(xr[idx], xi[idx]);
        }
        dft8(a);
        group_sync(g);
        // stored [r][m'][j0 ^ m'] in rows of 72: bank 8 ((r + m') mod 4) +
        // (j0 ^ m'), distinct both for these stores (r fixed) and for
        // pass 3's loads (j0 fixed)
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (r > 0) a[r] = cmul(a[r], p2re[r * 8 + j0], p2im[r * 8 + j0]);
          const int idx = r * kRow + mp * 8 + (j0 ^ mp);
          xr[idx] = a[r].x;
          xi[idx] = a[r].y;
        }
      }
      group_sync(g);
      // pass 3: thread (m', r) = (gt & 7, gt >> 3), DFT over j0 -> k'';
      // Z[m' + 8 r + 64 k''] stored at zpos
      {
        const int mp = gt & 7, r = gt >> 3;
#pragma unroll
        for (int j0 = 0; j0 < 8; ++j0) {
          const int idx = r * kRow + mp * 8 + (j0 ^ mp);
          a[j0] = make_float2(xr[idx], xi[idx]);
        }
        dft8(a);
        group_sync(g);
#pragma unroll
        for (int k2 = 0; k2 < 8; ++k2) {
          const int idx = zpos(mp + 8 * r + 64 * k2);
          xr[idx] = a[k2].x;
          xi[idx] = a[k2].y;
        }
      }
      group_sync(g);
      // epilogue: thread u takes bins k = 8u + i and pairs Z[k] with
      // Z[512 - k] (k = 0 pairs with itself):
      // X[k] = E + W1024^k O, E = (Z[k] + conj Z[-k]) / 2,
      // O = (Z[k] - conj Z[-k]) / 2i
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = 8 * gt + i;
        const int ka = zpos(k), kb = zpos((512 - k) & 511);
        const float ar = xr[ka], ai = xi[ka], br = xr[kb], bi = xi[kb];
        const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
        const float orr = 0.5f * (ai + bi), oi = -0.5f * (ar - br);
        const float wr = tpre[i * 64 + gt], wi = tpim[i * 64 + gt];
        const float Xr = er + (wr * orr - wi * oi);
        const float Xi = ei + (wr * oi + wi * orr);
        m2[i] = Xr * Xr + Xi * Xi;
      }
      group_sync(g);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) m2[i] = 0.f;  // no signal: |X|^2 = 0
    }
    if (out_bf16) {
      __nv_bfloat162 h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(m2[2 * i], m2[2 * i + 1]);
      *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(out) + o) =
          *reinterpret_cast<const uint4*>(h);
    } else {
      float4* dst = reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + o);
      dst[0] = make_float4(m2[0], m2[1], m2[2], m2[3]);
      dst[1] = make_float4(m2[4], m2[5], m2[6], m2[7]);
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
  const long long blocks = (long long)B * ((n_frames + kRun - 1) / kRun);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // 64 KB a block, three blocks an SM: the largest shared-memory carveout
  const int smem = kSmemFloats * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      frames_mag2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(frames_mag2_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  // 16-byte loads of the staged frames: a clip's row and the trim start
  // (a multiple of 512 samples) are then 16-byte aligned
  const int vec = ((uintptr_t)waves % 16 == 0) && (L % 4 == 0);
  frames_mag2_kernel<<<(unsigned)blocks, kFrameThreads, smem, (cudaStream_t)stream>>>(
      (const float*)waves, (const int*)info, out, out_bf16, L, n_frames, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
