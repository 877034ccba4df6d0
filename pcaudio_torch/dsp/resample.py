"""Kaiser-windowed-sinc resampling, librosa ``kaiser_fast`` style
(counterpart of ``pcaudio/dsp/resample.py``).

The eval sweeps re-featurize audio at lower rates with
``librosa.resample(x, fs_og, fs, res_type='kaiser_fast', scale=True)``
(``Code/pceval.py:75``).  resampy's ``kaiser_fast`` is a windowed-sinc
interpolation filter: 16 zero crossings, rolloff 0.85, Kaiser β ≈ 8.5555.
resampy tabulates the filter and interpolates the table; like the JAX
function, this evaluates the continuous filter exactly at each output
sample's fractional offset, in f32, so the two stacks agree to f32
rounding.  ``scale=True`` divides by ``sqrt(target / orig)``, and the output
length is librosa's ``ceil(n · target / orig)``.

Buffers are fixed-size ``[B, L]`` with per-clip lengths; samples at or past
a clip's length read as zeros.  This is plain PyTorch on either device:
the JAX package computes it outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

KAISER_FAST = dict(num_zeros=16, beta=8.555504641634386, rolloff=0.85)

# output samples a pass gathers for, times the batch and the taps: bounds
# the [B, block, taps] gather's memory
_GATHER_ELEMS = 1 << 25


def resample_length(n: int, orig_sr: int, target_sr: int) -> int:
    """Output length, librosa convention: ``ceil(n * target/orig)``."""
    return int(-(-n * target_sr // orig_sr))


def _kaiser(u: torch.Tensor, half_width: float, beta: float) -> torch.Tensor:
    """Continuous Kaiser window on ``[-half_width, half_width]``."""
    x = u / half_width
    inside = x.abs() <= 1.0
    x = torch.where(inside, x, 1.0)
    w = (torch.special.i0(beta * torch.sqrt(1.0 - x * x))
         / torch.special.i0(torch.tensor(beta, dtype=torch.float32,
                                         device=u.device)))
    return torch.where(inside, w, 0.0)


def batched_resample(
    waves: torch.Tensor,
    lengths: torch.Tensor,
    orig_sr: int,
    target_sr: int,
    num_zeros: int = KAISER_FAST["num_zeros"],
    beta: float = KAISER_FAST["beta"],
    rolloff: float = KAISER_FAST["rolloff"],
    scale: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resample each ``waves[b, :lengths[b]]`` from ``orig_sr`` to
    ``target_sr``.

    Returns ``(out [B, L_out], out_lengths [B])`` with
    ``L_out = resample_length(L, orig_sr, target_sr)`` and
    ``out_lengths = ceil(lengths · target / orig)``; samples past a clip's
    output length are zero.  f32 throughout.
    """
    if orig_sr == target_sr:
        return waves, lengths
    B, L = waves.shape
    dev = waves.device
    ratio = target_sr / orig_sr
    scale_f = min(1.0, ratio)  # filter stretch when downsampling
    W = int(-(-num_zeros // scale_f))  # filter half-width in input samples
    n_out = resample_length(L, orig_sr, target_sr)
    # output time i in input samples is i·p/q exactly (p/q = orig/target
    # reduced)
    g = math.gcd(orig_sr, target_sr)
    p, q = orig_sr // g, target_sr // g

    lengths = lengths.to(device=dev, dtype=torch.int64).clamp(0, L)
    x = waves.float() * (torch.arange(L, device=dev)[None, :] < lengths[:, None])
    # W zeros on the left and W + 1 on the right: every tap index lands in
    # the buffer, and the ones outside the clip read zeros
    x = torch.nn.functional.pad(x, (W, W + 1))
    offs = torch.arange(-W, W + 1, device=dev)
    # prototype lowpass rolloff·sinc(rolloff·u)·kaiser(u), its amplitude
    # scaled by the stretch when downsampling (resampy)
    amp = scale_f if scale_f < 1.0 else 1.0
    out = torch.empty(B, n_out, dtype=torch.float32, device=dev)
    block = max(1, _GATHER_ELEMS // (B * (2 * W + 1)))
    for i0 in range(0, n_out, block):
        i = torch.arange(i0, min(n_out, i0 + block), device=dev)
        t_num = i * p
        n0 = t_num // q
        frac = (t_num - n0 * q).to(torch.float32) / q
        u = scale_f * (frac[:, None] - offs[None, :].to(torch.float32))
        taps = (amp * rolloff * torch.sinc(rolloff * u)
                * _kaiser(u, float(num_zeros), beta))
        xg = x[:, n0[:, None] + offs[None, :] + W]          # [B, n, taps]
        out[:, i0: i0 + len(i)] = (xg * taps).sum(-1)
    out_lengths = (lengths * q + p - 1) // p
    out = out * (torch.arange(n_out, device=dev)[None, :] < out_lengths[:, None])
    if scale:
        out = out / torch.sqrt(torch.tensor(ratio, dtype=torch.float32,
                                            device=dev))
    return out, out_lengths


def resample(wave: torch.Tensor, length, orig_sr: int, target_sr: int,
             **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """One clip: ``wave [L]``, ``length`` → ``(out [L_out], out_length)``;
    :func:`batched_resample` of a batch of one."""
    length = torch.as_tensor(length, device=wave.device).reshape(1)
    out, n = batched_resample(wave[None], length, orig_sr, target_sr, **kw)
    return out[0], n[0]
