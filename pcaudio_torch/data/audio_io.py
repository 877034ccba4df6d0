"""Host-side audio ingest: WAV decode into fixed-size padded batches (a copy
of ``pcaudio/data/audio_io.py``, so the port imports nothing of the JAX
package).

The reference decodes with ``librosa.load`` (audioread/soundfile) per clip in
a Python loop.  ESC-50 ships 44.1 kHz WAVs, so a stdlib-``wave`` + numpy
decoder covers the real data path.  Decoding happens once at ingest; the
result is a ``[B, L]`` float32 buffer + lengths vector that the device
pipeline (trim → STFT) consumes.  The native (C++) decoder,
:mod:`pcaudio_torch.native`, slots in behind :func:`load_wav_batch`.
"""
from __future__ import annotations

import wave
from typing import Sequence, Tuple

import numpy as np


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a PCM WAV file to mono float32 in [-1, 1] (librosa.load
    convention: int PCM scaled by 1/2^(bits-1), channels averaged)."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        sw = w.getsampwidth()
        ch = w.getnchannels()
        sr = w.getframerate()
        raw = w.readframes(n)
    if sw == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:  # 8-bit WAV is unsigned
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sw == 3:  # 24-bit packed
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV sample width {sw} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def pad_batch(
    clips: Sequence[np.ndarray], buffer_len: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack ragged clips into a zero-padded ``[B, buffer_len]`` float32
    buffer + ``[B]`` int32 lengths (clips longer than the buffer are
    truncated)."""
    B = len(clips)
    out = np.zeros((B, buffer_len), np.float32)
    lengths = np.zeros((B,), np.int32)
    for i, c in enumerate(clips):
        n = min(len(c), buffer_len)
        out[i, :n] = c[:n]
        lengths[i] = n
    return out, lengths


def load_wav_batch(
    paths: Sequence[str], buffer_len: int, use_native: str = "auto"
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode many WAVs into one padded batch.

    ``use_native`` = "auto" (the native C++ threaded decoder when it
    builds, Python otherwise), "never", or "always" (native, or raise).
    """
    if use_native != "never":
        from pcaudio_torch import native

        # "always" lets the build's RuntimeError through
        if use_native == "always" or native.available():
            return native.decode_wav_batch(paths, buffer_len)
    return pad_batch([load_wav(p)[0] for p in paths], buffer_len)
