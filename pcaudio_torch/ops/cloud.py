"""Spectrogram grid → point cloud (counterpart of ``pcaudio/ops/cloud.py``).

Coordinates as the reference builds them:
  * framewise: ``farr = linspace(0, fs/2, n_fft//2 + 1) / fs``, Nyquist kept
    (``Code/settransformer.py:40``);
  * temporal: ``farr = linspace(0, fs/2, n_fft//2) / fs`` (Nyquist dropped)
    and ``tarr = linspace(0, (hop_factor·n_fft/fs)·Nt, Nt)``
    (``Code/settransformertemp.py:40-41``);
  * temporal row order: frequency fastest, row ``i`` is
    ``(f = i % F, t = i // F)`` (``Code/dataset.py:161-166``).
"""
from __future__ import annotations

import torch


def freq_coords(num_bins: int, fs: int, device=None) -> torch.Tensor:
    """Normalized frequency coordinates ``linspace(0, fs/2, num_bins)/fs``."""
    return torch.linspace(0.0, fs / 2.0, num_bins, dtype=torch.float32,
                          device=device) / fs


def time_coords(num_frames: int, n_fft: int, fs: int, hop_factor: float = 0.5,
                device=None) -> torch.Tensor:
    """Temporal coordinates ``linspace(0, (hop_factor·n_fft/fs)·Nt, Nt)``."""
    end = (hop_factor * n_fft / fs) * num_frames
    return torch.linspace(0.0, end, num_frames, dtype=torch.float32,
                          device=device)


def frame_cloud(frames: torch.Tensor, farr: torch.Tensor) -> torch.Tensor:
    """Framewise 2-D clouds: ``[..., F]`` log-magnitude frames →
    ``[..., F, 2]`` points ``(f_norm, log_mag)``."""
    return torch.stack([farr.expand_as(frames), frames], dim=-1)


def grid_cloud(grid_tf: torch.Tensor, farr: torch.Tensor,
               tarr: torch.Tensor) -> torch.Tensor:
    """Temporal 3-D clouds: ``[..., Nt, F]`` log-magnitude grids →
    ``[..., Nt·F, 3]`` points ``(f_norm, t_sec, log_mag)``, frequency
    fastest."""
    nt, f = grid_tf.shape[-2:]
    pts = torch.stack([farr[None, :].expand_as(grid_tf),
                       tarr[:, None].expand_as(grid_tf), grid_tf], dim=-1)
    return pts.reshape(*grid_tf.shape[:-2], nt * f, 3)
