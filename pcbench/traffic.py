"""The one traffic generator: synthetic ESC-10 clips made on the device
from the run's seed, and the batches every driver cuts from them, by the
parameters of a mix's file (``workloads/<cell>.json``).

The clips follow the recipe of ``pcaudio_torch/data/synthetic.py::
synth_clip`` (signature 2: three class-keyed partials, a class-banded noise
formant one octave wide, an amplitude envelope at a class rate, a noise
floor 18 dB down, peak 0.25), rewritten in torch and drawn from a
``torch.Generator`` on the device in a few large calls, so that 1,024
clips cost milliseconds.  Every seed gives the same sizes: the same class
counts and the same set of clip lengths (stratified over the mix's range),
in an order the seed draws.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from pcbench.weights import derived_seed

FS = 44100
NUM_CLASSES = 10


def _gen(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derived_seed(seed, stream))


def synth_clips(classes: torch.Tensor, n: int, gen: torch.Generator,
                block: int = 128) -> torch.Tensor:
    """``[B, n]`` f32 clips of ``classes [B]`` (on the generator's device)."""
    dev = classes.device
    t = torch.arange(n, device=dev, dtype=torch.float64)[None] / FS
    freqs = torch.fft.rfftfreq(n, d=1.0 / FS, device=dev)
    out = []
    for i in range(0, classes.shape[0], block):
        c = classes[i: i + block, None].double()
        b = c.shape[0]
        normal = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=torch.float64)
        uniform = lambda *s: torch.rand(*s, generator=gen, device=dev, dtype=torch.float64)
        f0 = 180.0 * 2.0 ** (c * 0.45) * (1.0 + 0.02 * normal(b, 1))
        x = torch.zeros(b, n, device=dev, dtype=torch.float64)
        for p in range(1, 4):
            amp = 1.0 / (1.0 + torch.remainder(p + c, 3))
            cycles = torch.remainder(f0 * p * t, 1.0)
            x += amp * torch.sin(2 * math.pi * cycles + 2 * math.pi * uniform(b, 1))
        fc = 240.0 * 2.0 ** (c * 0.5) * (1.0 + 0.05 * normal(b, 1))
        spec = torch.fft.rfft(torch.randn(b, n, generator=gen, device=dev))
        lf = torch.log2(freqs.clamp_min(1.0)[None] / fc)
        spec = spec * torch.exp(-0.5 * (lf / 0.5) ** 2).float()
        band = torch.fft.irfft(spec, n).double()
        x += band * (1.5 / (band.std(dim=1, keepdim=True) + 1e-12))
        env = 0.55 + 0.45 * torch.sin(2 * math.pi * torch.remainder((1.0 + 0.5 * c) * t, 1.0)
                                      + 2 * math.pi * uniform(b, 1))
        x = x * env + 0.125 * normal(b, n)
        x = x * (0.25 / x.abs().amax(dim=1, keepdim=True))
        out.append(x.float())
    return torch.cat(out)


def _order(seed: int, stream: int, n: int) -> torch.Tensor:
    """A permutation of ``n`` drawn on the host from the seed."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(derived_seed(seed, stream)))


def clip_set(seed: int, stream: int, count: int, seconds: Tuple[float, float],
             buffer: int, device) -> Dict[str, torch.Tensor]:
    """``count`` clips in ``[count, buffer]`` buffers, zeros past each
    clip's length: ``waves``, ``lengths`` (int32), ``labels`` (int64).
    The lengths are the ``count`` midpoints of ``seconds``' range and the
    classes cycle over the ten, each set shuffled by the seed."""
    lo, hi = seconds
    mids = [min(buffer, round(FS * (lo + (hi - lo) * (i + 0.5) / count))) for i in range(count)]
    lengths = torch.tensor(mids, dtype=torch.int32)[_order(seed, 2 * stream, count)]
    labels = (torch.arange(count) % NUM_CLASSES)[_order(seed, 2 * stream + 1, count)]
    labels = labels.to(device)
    waves = synth_clips(labels, buffer, _gen(seed, 1000 + stream, device))
    lengths = lengths.to(device)
    waves *= torch.arange(buffer, device=device)[None, :] < lengths[:, None].long()
    return {"waves": waves.contiguous(), "lengths": lengths, "labels": labels}


def clip_pool(seed: int, wl: dict, device) -> List[Dict[str, torch.Tensor]]:
    """``wl["pool"]`` distinct sets of ``wl["clips"]`` clips (serving
    batches, sweep calls)."""
    return [clip_set(seed, 10 + i, wl["clips"], tuple(wl["clip_seconds"]),
                     wl["buffer_samples"], device) for i in range(wl["pool"])]


def frame_pool(seed: int, wl: dict, n_fft: int, device) -> List[Dict[str, torch.Tensor]]:
    """``wl["pool"]`` batches of ``wl["batch"]`` framewise clouds ``[batch,
    n_fft//2 + 1, 2]`` (f, log-magnitude) with their clips' labels, the
    frames of enough clips shuffled by the seed, every row distinct."""
    from pcbench.reference.expt2 import valid_frames

    need = wl["pool"] * wl["batch"]
    clips = clip_set(seed, 900, wl["clips"], tuple(wl["clip_seconds"]),
                     wl["buffer_samples"], device)
    clouds, labels = valid_frames(clips["waves"], clips["lengths"], clips["labels"],
                                  n_fft, FS)
    if clouds.shape[0] < need:
        raise ValueError(f"{wl['clips']} clips give {clouds.shape[0]} frames, "
                         f"fewer than the {need} the pool needs")
    pick = _order(seed, 901, clouds.shape[0])[:need].to(device)
    clouds, labels = clouds[pick], labels[pick]
    b = wl["batch"]
    return [{"points": clouds[i * b: (i + 1) * b].contiguous(),
             "labels": labels[i * b: (i + 1) * b].contiguous()} for i in range(wl["pool"])]
