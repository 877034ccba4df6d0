"""Waveform → trimmed, reflect-padded STFT |X|² chunks: kernel K3
(``csrc/featurize.cu``, the port of ``pcaudio/ops/kernels/featurize.py::
fused_chunk_mag2``) and its plain PyTorch version.

The kernel reads each wave once for the librosa ``trim(top_db)`` bounds and
once for the frames of the trimmed signal (periodic Hann, ``n_fft`` 1024,
hop 512, centered reflect padding across the trim edges), and writes the
unnormalised |X|² with the Nyquist bin dropped, cut into ``num_frames``
chunks with the remainder dropped.  No log: the caller logs the top-K
winners only.
"""
from __future__ import annotations

from typing import Tuple

import torch

from pcaudio_torch.dsp import (
    chunk_mask, temporal_chunks, trim_bounds, trimmed_stft_mag2)
from pcaudio_torch.ops.kernels import _build

N_FFT = 1024


def _check(waves: torch.Tensor, lengths: torch.Tensor, n_fft: int,
           num_frames: int, out_dtype) -> int:
    """Validate the call; return the chunk count ``C``."""
    if n_fft != N_FFT:
        # The trim detector's hop is tied to n_fft // 2 and a frame is 4
        # of its blocks, which is librosa's fixed 2048/512 only at 1024.
        raise ValueError(f"fused featurize is librosa-exact only at n_fft="
                         f"{N_FFT} (got {n_fft}): its trim detector shares "
                         "the STFT hop")
    if waves.dim() != 2 or lengths.shape != (waves.shape[0],):
        raise ValueError(f"waves [B, L] and lengths [B] expected, got "
                         f"{tuple(waves.shape)} and {tuple(lengths.shape)}")
    if waves.dtype != torch.float32:
        raise TypeError(f"waves must be float32, got {waves.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    C = (1 + waves.shape[1] // (n_fft // 2)) // num_frames
    if C < 1:
        raise ValueError(f"buffer of {waves.shape[1]} samples holds no "
                         f"{num_frames}-frame chunk")
    return C


def fused_chunk_mag2_plain(waves: torch.Tensor, lengths: torch.Tensor, *,
                           n_fft: int = N_FFT, num_frames: int = 10,
                           trim: bool = True, top_db: float = 60.0,
                           out_dtype=torch.bfloat16
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_chunk_mag2` (f32 inside,
    ``torch.fft.rfft``), built from ``pcaudio_torch.dsp``."""
    C = _check(waves, lengths, n_fft, num_frames, out_dtype)
    hop = n_fft // 2
    if trim:
        start, tlen = trim_bounds(waves, lengths, top_db=top_db)
    else:
        tlen = lengths.to(device=waves.device, dtype=torch.int64).clamp(
            0, waves.shape[1])
        start = torch.zeros_like(tlen)
    spec = trimmed_stft_mag2(waves, start, tlen, n_fft, C * num_frames)
    chunks, mask = temporal_chunks(spec, 1 + tlen // hop, num_frames)
    return chunks.to(out_dtype), mask


def fused_chunk_mag2(waves: torch.Tensor, lengths: torch.Tensor, *,
                     n_fft: int = N_FFT, num_frames: int = 10,
                     trim: bool = True, top_db: float = 60.0,
                     out_dtype=torch.bfloat16
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``waves [B, L]`` f32 + ``lengths [B]`` → ``(chunk_mag2 [B, C,
    num_frames, n_fft//2] out_dtype, chunk_mask [B, C] bool)`` with
    ``C = (1 + L // hop) // num_frames``.  A chunk is valid iff
    ``(c + 1)·num_frames ≤ 1 + tlen // hop``; frames of invalid chunks are
    finite garbage.

    CPU tensors take :func:`fused_chunk_mag2_plain`; CUDA tensors the
    kernel.
    """
    if waves.device.type == "cpu":
        return fused_chunk_mag2_plain(waves, lengths, n_fft=n_fft,
                                      num_frames=num_frames, trim=trim,
                                      top_db=top_db, out_dtype=out_dtype)
    C = _check(waves, lengths, n_fft, num_frames, out_dtype)
    if not (waves.is_cuda and waves.is_contiguous()):
        raise ValueError("waves must be a contiguous CUDA tensor")
    B, L = waves.shape
    hop = n_fft // 2
    lengths = lengths.to(device=waves.device, dtype=torch.int32).contiguous()
    info = torch.empty((B, 2), dtype=torch.int32, device=waves.device)
    out = torch.empty((B, C, num_frames, hop), dtype=out_dtype,
                      device=waves.device)
    stream = _build.stream_of(waves)
    _build.launch("pcaudio_trim_bounds", waves.data_ptr(), lengths.data_ptr(),
                  info.data_ptr(), B, L, int(trim), float(top_db), stream)
    _build.launch("pcaudio_chunk_mag2", waves.data_ptr(), info.data_ptr(),
                  out.data_ptr(), int(out_dtype == torch.bfloat16), B, L,
                  C * num_frames, stream)
    fused_chunk_mag2.launches += 1
    return out, chunk_mask(1 + info[:, 1] // hop, C, num_frames)


fused_chunk_mag2.launches = 0
