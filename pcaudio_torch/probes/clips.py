"""Synthetic inputs for the smoke run, the stage probes and the tests: clips
of tones plus noise at 44.1 kHz in buffers of 220,672 samples (5 s, as
``bench.py``), with the edge cases the featurize kernel must keep finite and
masked, a ragged variant with the lengths and trimmed lead-ins that serving
traffic sends, and a top-K grid with -0.0 entries.
"""
from __future__ import annotations

import numpy as np

FS = 44100
L = 220672            # 5 s at 44.1 kHz, as bench.py


def synthetic_waves(B, rng):
    """Tones plus noise at 44.1 kHz, length 220500, with the edge cases the
    featurize kernel must keep finite and masked."""
    t = np.arange(L, dtype=np.float32) / FS
    f0 = rng.uniform(100.0, 4000.0, (B, 1)).astype(np.float32)
    w = (0.3 * np.sin(2 * np.pi * f0 * t) * rng.uniform(0.1, 1.0, (B, 1))
         + 0.02 * rng.standard_normal((B, L))).astype(np.float32)
    lengths = np.full(B, 220500, np.int32)
    w[1, :FS] = 0.0                  # 1 s of leading and trailing silence
    w[1, 220500 - FS:] = 0.0
    lengths[2] = 700                 # shorter than n_fft
    lengths[3] = 1
    w[:, 220500:] = 0.0
    return w, lengths


def ragged_waves(B, rng):
    """synthetic_waves with the traffic the noise batch never sends: each
    clip cut to a random length from 0.5 s to 5 s (zeros past it) and every
    other clip led in by up to 1 s of near-silence (-100 dB) that the 60 dB
    trim cuts, so trim starts and last frames fall anywhere."""
    w, lengths = synthetic_waves(B, rng)
    cut = rng.integers(FS // 2, 220500, B)
    lead = rng.integers(0, FS, B)
    for i in range(4, B):
        lengths[i] = cut[i]
        w[i, cut[i]:] = 0.0
        if i % 2:
            w[i, :lead[i]] *= 1e-5
    return w, lengths


def negzero_grid(N, F, seed):
    """[N, 10, F] float32 top-K grid: 16 levels (a tie grid) with 99 % of
    its entries zeroed, half of those as -0.0, so that the top K reaches
    into the zeros and -0.0 must tie with 0.0."""
    rng = np.random.default_rng(seed)
    m = np.floor(np.abs(rng.standard_normal((N, 10, F))) * 5.0).clip(0, 15) / 4.0
    u = rng.random(m.shape)
    m[u < 0.99] = 0.0
    m[u < 0.495] = -0.0
    return m.astype(np.float32)
