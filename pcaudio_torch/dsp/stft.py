"""Centered, reflect-padded STFT of trimmed clips: |X|² and the
log-magnitude (counterpart of ``pcaudio/dsp/stft.py`` + the centered framing
of ``pcaudio/dsp/framing.py``).

librosa 0.8 conventions: periodic Hann window, ``center=True`` with
'reflect' padding by ``n_fft//2``, ``n_fft``-point real transform.  The
signal is the trimmed window ``x[start : start + tlen]`` of each buffer;
reflection is single-bounce (``j < 0 → −j``, ``j ≥ tlen → 2·tlen − 2 − j``,
then clamped into the window), as ``pcaudio.dsp.framing.reflect_index``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def stft_window(n_fft: int, device=None) -> torch.Tensor:
    """Periodic ('fftbins') Hann window of ``n_fft`` samples, f32."""
    k = torch.arange(n_fft, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n_fft)


def frame_positions(start: torch.Tensor, tlen: torch.Tensor, n_fft: int,
                    num_frames: int) -> torch.Tensor:
    """``[B, num_frames, n_fft]`` int64: the buffer position of each sample
    of each centered frame of the trimmed clip ``[start, start + tlen)``
    (hop ``n_fft // 2``, single-bounce reflection, clamped into the clip;
    position ``start`` where ``tlen`` is 0)."""
    dev = tlen.device
    hop = n_fft // 2
    t = torch.arange(num_frames, device=dev)[:, None]
    j = torch.arange(n_fft, device=dev)[None, :]
    p = (t * hop - n_fft // 2 + j)[None]                   # [1, T, n_fft]
    n = tlen.to(dtype=torch.int64)[:, None, None]
    p = torch.where(p < 0, -p, p)
    p = torch.where(p >= n, 2 * n - 2 - p, p)
    p = torch.minimum(p.clamp_min(0), (n - 1).clamp_min(0))
    return start.to(device=dev, dtype=torch.int64)[:, None, None] + p


def trimmed_stft_mag2(waves: torch.Tensor, start: torch.Tensor,
                      tlen: torch.Tensor, n_fft: int,
                      num_frames: int) -> torch.Tensor:
    """``|STFT|²`` of each trimmed clip → ``[B, num_frames, n_fft//2 + 1]``
    f32 (unnormalised, Nyquist kept).  Frames past the clip's last frame
    ``tlen // hop`` hold clamped-reflection garbage (finite)."""
    dev = waves.device
    idx = frame_positions(start.to(dev), tlen.to(dev), n_fft, num_frames)
    n = tlen.to(device=dev, dtype=torch.int64)[:, None, None]
    frames = torch.gather(waves.float(), 1,
                          idx.reshape(waves.shape[0], -1)).view(idx.shape)
    frames = torch.where(n > 0, frames, 0.0) * stft_window(n_fft, dev)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def stft_logmag(waves: torch.Tensor, start: torch.Tensor, tlen: torch.Tensor,
                n_fft: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched log-magnitude STFT of each trimmed clip
    ``waves[b, start : start + tlen]`` with hop ``n_fft // 2`` and an
    ``n_fft`` window (the reference's ``log(1e-8 + |X| / n_fft)``,
    ``Code/settransformer.py:45-52``).

    Returns ``(logmag [B, T_max, n_fft//2 + 1], frame_mask [B, T_max])``
    with ``T_max = 1 + L // hop``; frame t is valid iff
    ``t < 1 + tlen // hop`` (librosa ``center=True``).
    """
    B, L = waves.shape
    hop = n_fft // 2
    t_max = 1 + L // hop
    mag2 = trimmed_stft_mag2(waves, start, tlen, n_fft, t_max)
    logmag = torch.log(1.0e-8 + torch.sqrt(mag2) / n_fft)
    mask = (torch.arange(t_max, device=waves.device)[None, :]
            < 1 + tlen.to(waves.device)[:, None] // hop)
    return logmag, mask
