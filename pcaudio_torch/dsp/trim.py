"""dB-threshold silence trimming, batched (counterpart of
``pcaudio/dsp/trim.py``).

librosa 0.8 ``effects.trim(top_db=60)``: frame power of the signal with
frame 2048, hop 512, centered with 'reflect' padding; frames more than
``top_db`` below the loudest frame are silent; keep
``[first_nonsilent · hop, min(length, (last_nonsilent + 1) · hop))``.
Buffers are fixed-size ``[B, L]`` with per-clip lengths, and the result is
``(start, trimmed_length)`` per clip.  Lengths are clamped to ``[0, L]``.
"""
from __future__ import annotations

from typing import Tuple

import torch

_AMIN = 1.0e-10  # librosa power_to_db floor


def frame_power(waves: torch.Tensor, lengths: torch.Tensor,
                frame_length: int = 2048, hop_length: int = 512
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-square energy per centered frame → ``(mse [B, T], mask [B, T])``
    with ``T = 1 + L // hop_length``.

    Frame t spans samples ``[t·hop − frame_length/2, + frame_length)``: a
    main term of ``frame_length/hop`` block energies, plus the reflected
    samples left of 0 (first frames) and right of ``length`` (a window
    ending at ``length − 2``), as ``pcaudio/dsp/trim.py`` computes them.
    """
    B, L = waves.shape
    pad = frame_length // 2
    mdiv = frame_length // hop_length
    off = pad // hop_length
    if frame_length % hop_length or pad % hop_length:
        raise ValueError("frame_power needs hop_length | frame_length/2")
    dev = waves.device
    lengths = lengths.to(device=dev, dtype=torch.int64).clamp(0, L)
    x = waves.float() * (torch.arange(L, device=dev)[None, :] < lengths[:, None])
    T = 1 + L // hop_length

    nb = T + mdiv
    xb = torch.nn.functional.pad(x, (0, max(0, nb * hop_length - L)))
    eb = (xb[:, : nb * hop_length] ** 2).view(B, nb, hop_length).sum(-1)
    t = torch.arange(T, device=dev)
    main = torch.zeros(B, T, device=dev)
    for i in range(-off, mdiv - off):
        idx = t + i
        ok = (idx >= 0) & (idx < nb)
        main = main + torch.where(ok, eb[:, idx.clamp(0, nb - 1)], 0.0)

    # left reflect: frame off − j mirrors samples [1, j·hop]
    x0sq = x[:, 0] ** 2
    left = torch.zeros(B, T, device=dev)
    for j in range(1, off + 1):
        span = eb[:, :j].sum(-1)
        nxt = x[:, min(j * hop_length, L - 1)] ** 2 * (j * hop_length < lengths)
        left[:, off - j] = torch.where(lengths > 0, span - x0sq + nxt, 0.0)

    # right reflect: positions [length, b) mirror a window ending at
    # length − 2; a local cumsum over the last frame_length + hop samples
    tail = frame_length + hop_length
    xt = torch.nn.functional.pad(x, (0, max(0, tail - L)))
    Lt = xt.shape[1]
    start = (lengths - tail).clamp(0, Lt - tail)
    lx = torch.gather(xt, 1, start[:, None] + torch.arange(tail, device=dev))
    lc = torch.nn.functional.pad(torch.cumsum(lx * lx, dim=1), (1, 0))
    offl = (lengths - start)[:, None]
    a = t[None, :] * hop_length - pad
    b = a + frame_length
    w = (b - lengths[:, None]).clamp(0, frame_length)
    hi = (offl - 1).clamp(0, tail).expand(B, T)
    lo = (offl - 1 - w).clamp(0, tail)
    crosses = (b > lengths[:, None]) & (a < lengths[:, None])
    right = torch.where(crosses, lc.gather(1, hi) - lc.gather(1, lo), 0.0)

    mse = (main + left + right) / frame_length
    mask = t[None, :] < 1 + lengths[:, None] // hop_length
    return mse, mask


def trim_bounds(waves: torch.Tensor, lengths: torch.Tensor,
                top_db: float = 60.0, frame_length: int = 2048,
                hop_length: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-silent window of each ``waves[b, :length]`` →
    ``(start [B], trimmed_length [B])`` int64.

    The threshold is relative to the clip's own loudest frame, so a
    constant (even all-zero) clip comes back untrimmed (librosa)."""
    mse, mask = frame_power(waves, lengths, frame_length, hop_length)
    lengths = lengths.to(device=mse.device, dtype=torch.int64).clamp(
        0, waves.shape[1])
    ref = torch.where(mask, mse, 0.0).amax(-1, keepdim=True).clamp_min(_AMIN)
    db = 10.0 * (torch.log10(mse.clamp_min(_AMIN)) - torch.log10(ref))
    nonsilent = (db > -top_db) & mask
    T = mse.shape[1]
    idx = torch.arange(T, device=mse.device)
    any_ns = nonsilent.any(-1)
    first = torch.where(nonsilent, idx, T).amin(-1)
    last = torch.where(nonsilent, idx, -1).amax(-1)
    start = torch.where(any_ns, first * hop_length, 0)
    end = torch.where(any_ns,
                      torch.minimum(lengths, (last + 1) * hop_length), 0)
    return start, end - start
