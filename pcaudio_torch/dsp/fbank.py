"""The Kaldi log-mel filterbank the Audio Spectrogram Transformer is fed
(``transformers``' ``ASTFeatureExtractor`` on its numpy path), batched over
``[B, L]`` buffers of 16 kHz clips with per-clip ``lengths``.

A clip of ``len`` samples makes ``1 + (len − 400) // 160`` frames (none
under 400 samples; Kaldi's ``snip_edges``), at most ``max_length``.  Each
frame of 400 samples (25 ms, hop 10 ms) loses its mean (DC offset), is
pre-emphasised (``y[0] = 0.03·x[0]``, ``y[i] = x[i] − 0.97·x[i−1]``), windowed
by a symmetric Hann window, and transformed by a 512-point ``rfft``; its
power spectrum goes through 128 triangular Kaldi-mel filters over
20-8,000 Hz (triangles in mel space), and ``log(max(·, 1.1920929e-07))``.
Rows past a clip's frames, up to ``max_length``, are zeros, and the grid
is normalised as ``(x − mean) / (2·std)`` (AudioSet's mean and std by
default).  Everything is f32: the transform is ``torch.fft.rfft`` as in
``dsp/stft.py``, and the mel product a full-f32 matrix product (PyTorch's
default; TF32 stays off unless a caller turns it on).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

FRAME, HOP, N_FFT = 400, 160, 512
PREEMPHASIS = 0.97
MEL_FLOOR = 1.192092955078125e-07
AUDIOSET_MEAN, AUDIOSET_STD = -4.2677393, 4.5689974


def num_frames(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """Frames of each clip: ``1 + (len − 400) // 160``, in ``[0, max_length]``."""
    return ((lengths.long() - FRAME) // HOP + 1).clamp(0, max_length)


def _mel(f):
    return 1127.0 * torch.log1p(f / 700.0)


@functools.lru_cache(maxsize=8)
def _filters(num_mel_bins: int, fs: int, device: torch.device) -> torch.Tensor:
    bins = N_FFT // 2 + 1
    edges = torch.linspace(float(_mel(torch.tensor(20.0, dtype=torch.float64))),
                           float(_mel(torch.tensor(fs / 2.0, dtype=torch.float64))),
                           num_mel_bins + 2, dtype=torch.float64)
    centre = _mel(torch.arange(bins, dtype=torch.float64) * (fs / N_FFT))
    slopes = edges[None, :] - centre[:, None]
    width = torch.diff(edges)
    down = -slopes[:, :-2] / width[:-1]
    up = slopes[:, 2:] / width[1:]
    return torch.minimum(down, up).clamp_min(0.0).float().to(device)


def mel_filters(num_mel_bins: int = 128, fs: int = 16000, device=None) -> torch.Tensor:
    """``[257, num_mel_bins]`` f32 Kaldi-mel triangles over 20 Hz to fs/2
    (computed in f64, as ``transformers.audio_utils.mel_filter_bank`` with
    ``mel_scale="kaldi"``, ``triangularize_in_mel_space=True``)."""
    return _filters(num_mel_bins, fs, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=8)
def _window(device: torch.device) -> torch.Tensor:
    n = torch.arange(FRAME, dtype=torch.float64)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / (FRAME - 1))).float().to(device)


def fbank_batch(waves: torch.Tensor, lengths: torch.Tensor, num_mel_bins: int = 128,
                max_length: int = 1024, mean: float = AUDIOSET_MEAN,
                std: float = AUDIOSET_STD, fs: int = 16000
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``waves [B, L]``, ``lengths [B]`` → ``(features [B, max_length,
    num_mel_bins]`` f32 normalised, ``frames [B]`` int64, the frames made
    from each clip's samples)."""
    B, L = waves.shape
    dev = waves.device
    frames = num_frames(lengths.to(dev), max_length)
    T = min(max_length, 1 + (L - FRAME) // HOP) if L >= FRAME else 0
    out = torch.zeros((B, max_length, num_mel_bins), dtype=torch.float32, device=dev)
    if T > 0:
        x = waves.float().unfold(1, FRAME, HOP)[:, :T]          # [B, T, 400]
        x = x - x.mean(-1, keepdim=True)
        x = torch.cat([x[..., :1] * (1.0 - PREEMPHASIS),
                       x[..., 1:] - PREEMPHASIS * x[..., :-1]], dim=-1) * _window(dev)
        spec = torch.fft.rfft(x, n=N_FFT, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        logmel = torch.log(torch.matmul(power, mel_filters(num_mel_bins, fs, dev))
                           .clamp_min(MEL_FLOOR))
        valid = torch.arange(T, device=dev)[None, :] < frames[:, None]
        out[:, :T] = torch.where(valid[..., None], logmel, 0.0)
    return (out - mean) / (2.0 * std), frames
