"""Deterministic synthetic ESC-shaped WAV corpus (a copy of
``pcaudio/data/synthetic.py``; the files it writes are byte-identical).

ESC-50 audio is not redistributable with this repo, so the end-to-end
harness (train → eval, ``pcaudio_torch.cli``) is exercised at real
scale on a generated stand-in corpus with the exact on-disk shape the
reference pipeline consumes (``Code/data_processing.py:8-38``): an
``esc50.csv`` metadata file plus 5-second 44.1 kHz 16-bit PCM mono WAVs,
40 clips per ESC-10 class, 5 folds.  Every byte is a pure function of the
seed.  Each class gets a distinct spectral signature (class-dependent
partial stack + AM envelope + noise floor) so models genuinely learn; the
corpus swaps for the real ESC-50 by changing two CLI flags
(docs/ACCURACY.md).
"""
from __future__ import annotations

import os
import struct
from typing import Sequence, Tuple

import numpy as np

from pcaudio_torch.data.esc import ESC10_CATEGORIES

FS = 44100
CLIP_SECONDS = 5.0


def write_wav_pcm16(path: str, x: np.ndarray, fs: int = FS) -> None:
    """Minimal 16-bit PCM mono WAV writer (no external deps)."""
    pcm = np.clip(np.asarray(x, np.float32) * 32767.0,
                  -32768, 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, fs, fs * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(pcm)) + pcm)


def synth_clip(cls: int, idx: int, seed: int = 0,
               n: int = int(FS * CLIP_SECONDS), fs: int = FS,
               signature: int = 2) -> np.ndarray:
    """One deterministic clip: class-dependent partials + AM + noise.

    Class signature: a class-keyed fundamental with 3 partials whose
    relative amplitudes rotate with the class, a class-rate amplitude
    envelope, and a broadband noise floor 18 dB down.  Per-clip variation
    (phase, detune, envelope offset, noise) comes from a counter-based RNG
    on (seed, cls, idx) — stable across processes and platforms.

    ``signature=2`` (default) is BROADBAND: partial fundamentals spread
    logarithmically (180 Hz → ~2.9 kHz) PLUS a class-banded noise formant
    (Gaussian-in-log-frequency energy band, one octave wide, center spread
    240 Hz → ~7.6 kHz).  Rationale, measured round 5: v1's tonal-only
    signature (fundamentals 110–440 Hz) is linearly separable on the
    1025-bin grid (a logistic probe reaches 99.9% in 100 steps) yet the
    reference FST recipe sat at EXACT chance for 50k+ steps on it — the
    class signal lived in 3 partials out of 1025 cloud points (~0.3%),
    with loud-point frequency COORDINATES differing by ~0.002 in
    normalized units, so set pooling diluted it ~300x.  Real ESC-10
    classes differ in broad spectral SHAPE (hundreds of informative
    bins), which is what lets the reference recipe train; the v2 formant
    reproduces that property.  ``signature=1`` reproduces the v1 corpus
    (the committed round-3/4 cycle artifacts)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, cls, idx]))
    t = np.arange(n, dtype=np.float64) / fs
    if signature == 1:
        f0 = 110.0 * (1.0 + cls / 3.0) * (1.0 + 0.02 * rng.standard_normal())
    else:
        f0 = 180.0 * 2.0 ** (cls * 0.45) * (1.0 + 0.02 * rng.standard_normal())
    x = np.zeros(n)
    for p in range(1, 4):
        amp = 1.0 / (1 + ((p + cls) % 3))
        x += amp * np.sin(2 * np.pi * f0 * p * t + rng.uniform(0, 2 * np.pi))
    if signature != 1:
        # class-banded noise formant: white noise shaped in the rfft
        # domain by a one-octave Gaussian in log2(f) centered on a
        # class-keyed, per-clip-detuned frequency
        fc = 240.0 * 2.0 ** (cls * 0.5) * (1.0 + 0.05 * rng.standard_normal())
        spec = np.fft.rfft(rng.standard_normal(n))
        freqs = np.fft.rfftfreq(n, d=1.0 / fs)
        lf = np.log2(np.maximum(freqs, 1.0) / fc)
        spec *= np.exp(-0.5 * (lf / 0.5) ** 2)
        band = np.fft.irfft(spec, n)
        x += band * (1.5 / (np.std(band) + 1e-12))
    env_rate = 1.0 + 0.5 * cls
    env = 0.55 + 0.45 * np.sin(2 * np.pi * env_rate * t + rng.uniform(0, 2 * np.pi))
    x = x * env + 0.125 * rng.standard_normal(n)
    x *= 0.25 / np.max(np.abs(x))
    return x.astype(np.float32)


def generate_esc_corpus(
    out_dir: str,
    clips_per_class: int = 40,
    categories: Sequence[str] = ESC10_CATEGORIES,
    seed: int = 0,
    clip_seconds: float = CLIP_SECONDS,
    signature: int = 2,
) -> Tuple[str, str]:
    """Write the corpus; returns ``(csv_path, audio_dir)`` ready for the
    ``--esc-csv`` / ``--esc-audio`` CLI flags.  Idempotent: existing files
    with the right size are kept (regeneration is a no-op)."""
    audio_dir = os.path.join(out_dir, "audio") + os.sep
    os.makedirs(audio_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "esc50.csv")
    n = int(FS * clip_seconds)
    rows = []
    for ci, cat in enumerate(categories):
        for idx in range(clips_per_class):
            fold = 1 + idx % 5
            fname = f"{fold}-{100000 + ci * 1000 + idx}-A-{ci}.wav"
            fpath = os.path.join(audio_dir, fname)
            expect = 44 + 2 * n
            if not (os.path.exists(fpath) and os.path.getsize(fpath) == expect):
                write_wav_pcm16(fpath, synth_clip(ci, idx, seed, n=n,
                                                  signature=signature))
            rows.append((fname, fold, cat))
    with open(csv_path, "w") as f:
        f.write("filename,fold,target,category,esc10,src_file,take\n")
        for fname, fold, cat in rows:
            f.write(f"{fname},{fold},0,{cat},True,0,A\n")
    return csv_path, audio_dir
