"""Temporal chunking of spectrogram frames (counterpart of
``pcaudio/dsp/featurize.py::temporal_chunks``, reference
``Code/settransformertemp.py:52-59``): the Nyquist bin is dropped, frames
are cut into ``num_frames``-frame chunks with the remainder dropped, and a
chunk is valid iff all its frames are."""
from __future__ import annotations

from typing import Tuple

import torch


def temporal_chunks(spec: torch.Tensor, n_valid: torch.Tensor,
                    num_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``spec [B, T, F+1]``, ``n_valid [B]`` valid frames per clip →
    ``(chunks [B, C, num_frames, F], chunk_mask [B, C])``, ``C = T // num_frames``."""
    B, T, f = spec.shape
    C = T // num_frames
    chunks = spec[:, : C * num_frames, : f - 1].reshape(B, C, num_frames, f - 1)
    return chunks, chunk_mask(n_valid.to(spec.device), C, num_frames)


def chunk_mask(n_valid: torch.Tensor, num_chunks: int,
               num_frames: int) -> torch.Tensor:
    """``[B, num_chunks]``: chunk c is valid iff its frames
    ``[c·num_frames, (c+1)·num_frames)`` are all among the ``n_valid``."""
    c = torch.arange(num_chunks, device=n_valid.device)
    return (c[None, :] + 1) * num_frames <= n_valid[:, None]
