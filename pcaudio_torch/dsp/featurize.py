"""Batched featurization: trim → STFT → log-magnitude, and temporal chunking
(counterpart of ``pcaudio/dsp/featurize.py``).

``featurize_batch`` is the training recipes' featurizer (reference
``Code/settransformer.py:45-52``, temporal ``Code/settransformertemp.py:
50-59``).  Temporal chunks drop the Nyquist bin and the frame remainder, and
a chunk is valid iff all its frames are.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pcaudio_torch.dsp.stft import stft_logmag
from pcaudio_torch.dsp.trim import trim_bounds


@dataclasses.dataclass(frozen=True)
class FeaturizeConfig:
    """STFT featurizer configuration: the training recipes' fields of the
    JAX package's config, with its names and defaults.  Its resampling
    (``target_fs``, which raises), ``win_length < n_fft`` and untrimmed
    forms are not ported yet (ROADMAP Queue 1)."""

    fs: int = 44100
    target_fs: Optional[int] = None
    n_fft: int = 2048
    hop_factor: float = 0.5
    top_db: float = 60.0


def featurize_batch(waves: torch.Tensor, lengths: torch.Tensor,
                    cfg: FeaturizeConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """``waves [B, L]`` + ``lengths [B]`` → ``(logmag [B, T_max, F],
    frame_mask [B, T_max])``, ``T_max = 1 + L // hop``, ``F = n_fft//2 + 1``:
    librosa's 60 dB trim at the original rate, then the centered STFT of
    the kept window."""
    if cfg.target_fs is not None and cfg.target_fs != cfg.fs:
        raise NotImplementedError("resampling is not ported yet (ROADMAP "
                                  "Queue 1)")
    if cfg.hop_factor != 0.5:
        raise NotImplementedError("a hop other than n_fft/2 is not ported "
                                  "yet (ROADMAP Queue 1)")
    start, tlen = trim_bounds(waves, lengths, top_db=cfg.top_db)
    return stft_logmag(waves, start, tlen, cfg.n_fft)


def temporal_chunks(spec: torch.Tensor, n_valid: torch.Tensor,
                    num_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``spec [B, T, F+1]``, ``n_valid [B]`` valid frames per clip →
    ``(chunks [B, C, num_frames, F], chunk_mask [B, C])``, ``C = T // num_frames``."""
    B, T, f = spec.shape
    C = T // num_frames
    chunks = spec[:, : C * num_frames, : f - 1].reshape(B, C, num_frames, f - 1)
    return chunks, chunk_mask(n_valid.to(spec.device), C, num_frames)


def batched_temporal_chunks(logmag: torch.Tensor, frame_mask: torch.Tensor,
                            num_frames: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`temporal_chunks` of ``featurize_batch``'s output, the valid
    frame count taken from ``frame_mask [B, T]``."""
    return temporal_chunks(logmag, frame_mask.sum(-1), num_frames)


def chunk_mask(n_valid: torch.Tensor, num_chunks: int,
               num_frames: int) -> torch.Tensor:
    """``[B, num_chunks]``: chunk c is valid iff its frames
    ``[c·num_frames, (c+1)·num_frames)`` are all among the ``n_valid``."""
    c = torch.arange(num_chunks, device=n_valid.device)
    return (c[None, :] + 1) * num_frames <= n_valid[:, None]
