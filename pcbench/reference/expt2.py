"""Experiment 2 of the paper (``Code/pceval.py:107-192``), point
subsampling of FST's frame clouds, in plain PyTorch: the frames, the ranks
that decide which points each mask keeps, and the masked forwards.

A mask keeps the points whose rank is under K: maxK ranks by
log-magnitude, randK by uniform noise, each a stable descending order (ties
to the lower index, -0.0 with 0.0).  The noise of randK is the port's
stated convention: per microbatch of 1,024 frames, ``torch.rand((nruns,
frames, points))`` from a ``torch.Generator`` on the frames' device seeded
with ``np.random.SeedSequence([seed, microbatch]).generate_state(1,
np.uint64)``.  Forward ``j·(nruns + 1)`` of a microbatch is maxK at
``list_K[j]``, forward ``j·(nruns + 1) + 1 + r`` randK run r.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from pcbench.reference.featurize import frame_logmag, freq_coords
from pcbench.reference.precision import exact
from pcbench.reference.st import st_forward

MICROBATCH = 1024


def default_list_K(n_total: int):
    ks = list(range(1, n_total, 50))
    ks[-1] = n_total
    return ks


def microbatch_generator(seed: int, mb: int, device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), mb]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def ranks_desc(x: torch.Tensor) -> torch.Tensor:
    order = torch.sort(0.0 - x, dim=-1, stable=True).indices
    iota = torch.arange(x.shape[-1], device=x.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, iota)


def valid_frames(waves, lengths, labels, n_fft: int, fs: int):
    """``(clouds [n, F, 2], labels [n])`` of the valid frames, clip-major."""
    logmag, valid = frame_logmag(waves, lengths, n_fft)
    B, T, F = logmag.shape
    keep = valid.reshape(-1)
    frames = logmag.reshape(B * T, F)[keep]
    farr = freq_coords(F, fs, waves.device)
    return (torch.stack([farr.expand_as(frames), frames], -1),
            labels.repeat_interleave(T)[keep])


def masked_logits(params, clouds, seed: int, list_K: Sequence[int], nruns: int,
                  forwards: Iterable[Tuple[int, int]], heads: int,
                  rnd: Callable = exact) -> Dict[Tuple[int, int], torch.Tensor]:
    """Logits of the forwards ``(microbatch, index)`` named, each ``[rows of
    that microbatch, classes]``."""
    out = {}
    want = sorted(set(forwards))
    for mb in sorted({m for m, _ in want}):
        x = clouds[mb * MICROBATCH: (mb + 1) * MICROBATCH]
        gen = microbatch_generator(seed, mb, x.device)
        noise = torch.rand((nruns,) + tuple(x.shape[:2]), generator=gen, device=x.device)
        rmax, rrand = ranks_desc(x[..., 1]), ranks_desc(noise)
        for m, f in want:
            if m != mb:
                continue
            j, r = divmod(f, nruns + 1)
            rank = rmax if r == 0 else rrand[r - 1]
            with torch.no_grad():
                out[(m, f)] = st_forward(params, x, rank < list_K[j], heads, rnd)
    return out
