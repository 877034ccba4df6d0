"""Batched featurization: trim → (resample) → STFT → log-magnitude, and
temporal chunking (counterpart of ``pcaudio/dsp/featurize.py``).

``featurize_batch`` is the training recipes' featurizer (reference
``Code/settransformer.py:45-52``, temporal ``Code/settransformertemp.py:
50-59``) and the eval sweeps' (``Code/pceval.py:55-76``: another rate, a
window shorter than ``n_fft``, a hop and a magnitude norm on the window).
Temporal chunks drop the Nyquist bin and the frame remainder, and a chunk is
valid iff all its frames are.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pcaudio_torch.dsp.resample import batched_resample, resample_length
from pcaudio_torch.dsp.stft import stft_logmag
from pcaudio_torch.dsp.trim import trim_bounds


@dataclasses.dataclass(frozen=True)
class FeaturizeConfig:
    """STFT featurizer configuration: the JAX package's fields, names and
    defaults (reference constants at ``Code/settransformer.py:34-41``; the
    eval sweeps set ``target_fs``, ``n_fft``, ``win_length``,
    ``hop_length_override`` and ``mag_norm`` per ``Code/pceval.py:55-76``).

    ``precision`` is accepted and changes nothing: the port's transform is
    an f32 ``rfft`` under either value, as K3 computes in f32 (the JAX
    package's "default" is a bf16-pass DFT product on the TPU)."""

    fs: int = 44100                 # sampling rate of the incoming buffers
    target_fs: Optional[int] = None  # resample to this rate first (expt 1)
    n_fft: int = 2048
    hop_factor: float = 0.5
    win_length: Optional[int] = None  # defaults to n_fft
    top_db: float = 60.0
    trim: bool = True
    log_floor: float = 1.0e-8
    hop_length_override: Optional[int] = None  # eval sweeps hop on win_length
    mag_norm: Optional[float] = None           # eval sweeps divide by win_length
    precision: str = "highest"
    out_dtype: str = "float32"      # or "bfloat16"

    @property
    def hop_length(self) -> int:
        if self.hop_length_override is not None:
            return self.hop_length_override
        return int(self.n_fft * self.hop_factor)

    @property
    def num_bins(self) -> int:
        return self.n_fft // 2 + 1


def trim_and_resample(waves: torch.Tensor, lengths: torch.Tensor,
                      cfg: FeaturizeConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first stage of :func:`featurize_batch`: librosa's 60 dB trim at
    the original rate (unless ``trim=False``), then the resampling of the
    kept window to ``target_fs``.  Returns ``(waves, start, tlen)``: each
    clip is ``waves[b, start : start + tlen]``, at ``target_fs`` when one
    is set.  Only ``fs``, ``target_fs``, ``trim`` and ``top_db`` matter."""
    B, L = waves.shape
    dev = waves.device
    lengths = lengths.to(device=dev, dtype=torch.int64).clamp(0, L)
    if cfg.trim:
        start, tlen = trim_bounds(waves, lengths, top_db=cfg.top_db)
    else:
        start, tlen = torch.zeros_like(lengths), lengths
    if cfg.target_fs is None or cfg.target_fs == cfg.fs:
        return waves, start, tlen
    # the kept window to the buffer front, zeros past it
    pos = start[:, None] + torch.arange(L, device=dev)[None, :]
    kept = torch.gather(waves.float(), 1, pos.clamp_max(L - 1))
    kept = kept * (torch.arange(L, device=dev)[None, :] < tlen[:, None])
    kept, tlen = batched_resample(kept, tlen, cfg.fs, cfg.target_fs)
    return kept, torch.zeros_like(tlen), tlen


def featurize_kept(waves: torch.Tensor, start: torch.Tensor,
                   tlen: torch.Tensor, cfg: FeaturizeConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second stage of :func:`featurize_batch`: the centered
    log-magnitude STFT of each clip ``waves[b, start : start + tlen]``."""
    logmag, mask = stft_logmag(waves, start, tlen, cfg.n_fft,
                               hop_length=cfg.hop_length,
                               win_length=cfg.win_length,
                               mag_norm=cfg.mag_norm, log_floor=cfg.log_floor)
    if cfg.out_dtype == "bfloat16":
        logmag = logmag.to(torch.bfloat16)
    return logmag, mask


def featurize_batch(waves: torch.Tensor, lengths: torch.Tensor,
                    cfg: FeaturizeConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """``waves [B, L]`` + ``lengths [B]`` → ``(logmag [B, T_max, F],
    frame_mask [B, T_max])``, ``F = n_fft//2 + 1`` and ``T_max =
    featurized_max_frames(L, cfg)``.  The JAX order: trim at the original
    rate, resample (:func:`trim_and_resample`), then the centered STFT
    (:func:`featurize_kept`)."""
    return featurize_kept(*trim_and_resample(waves, lengths, cfg), cfg)


def featurized_max_frames(buffer_len: int, cfg: FeaturizeConfig) -> int:
    """``T_max`` that :func:`featurize_batch` gives a ``buffer_len``-sample
    buffer under ``cfg``."""
    L = buffer_len
    if cfg.target_fs is not None and cfg.target_fs != cfg.fs:
        L = resample_length(L, cfg.fs, cfg.target_fs)
    return 1 + L // cfg.hop_length


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
