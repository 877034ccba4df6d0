"""P6, int16 waves (``scripts/probe_int16_load.py``: ``kern`` at :18,
``kern2`` at :38): on the TPU, whether a kernel can take int16 PCM blocks
and convert them itself, which would halve K3's input bytes.  Here:

- kern: [64, 512] int16 → f32·(1/32768), then x·xᵀ (f32 FMAs, one tiled
  SIMT kernel), held to ``matmul_bound``;
- sweep: one f32 sum per [432, 512] block of 512 waves, int16 against f32,
  i.e. the time to read K3's input at either width.  The script times all
  zeros, where a wrong kernel would pass; it is timed on those and checked
  on integers in [-4, 4) (exact sums).

    python -m pcaudio_torch.probes int16_load
"""
from __future__ import annotations

import torch

from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.ops.kernels.featurize_probes import (
    int16_gram, int16_gram_plain, pcm_to_float, wave_block_sums,
    wave_block_sums_plain)
from pcaudio_torch.ops.kernels.probes import matmul_bound
from pcaudio_torch.probes.timing import Case, measure, tf32_off

SOURCE = "pcaudio_torch/csrc/probe_stream.cu"
REPLACES = {"kern": "scripts/probe_int16_load.py:18",
            "sweep": "scripts/probe_int16_load.py:38"}
B, L = 64, 512                 # kern's rows
WAVES, ROWS, HOP = 512, 432, 512  # the sweep's blocks
SWEEP_LOADS = "16-byte loads, f32 adds, a block reduction"


def _gram_library(x):
    """The conversion, then one ``torch.mm``."""
    def call():
        xf = pcm_to_float(x)
        return torch.mm(xf, xf.t())
    return call


def cases(dev, gen):
    x = torch.randint(-32768, 32767, (B, L), generator=gen, device=dev, dtype=torch.int16)
    xf = pcm_to_float(x)
    out = [Case(
        "kern", lambda: int16_gram(x), lambda: int16_gram_plain(x),
        lambda ref: matmul_bound(xf, xf.t()), int16_gram, SOURCE, REPLACES["kern"],
        "f32 FMA (SIMT, 8 x 8 outputs a block, K split 4 ways)", ops={"f32": 2.0 * B * B * L},
        nbytes=2 * x.numel() + 4 * B * B,
        library=_gram_library(x), library_note="x.float()·(1/32768), torch.mm",
        iters=50, plain_iters=50, args=(x,))]
    for dt, name in ((torch.int16, "int16"), (torch.float32, "f32")):
        zeros = torch.zeros(WAVES, ROWS, HOP, dtype=dt, device=dev)
        ints = torch.randint(-4, 4, (WAVES, ROWS, HOP), generator=gen, device=dev, dtype=dt)
        out.append(Case(
            f"sweep {name}", lambda z=zeros: wave_block_sums(z),
            lambda z=zeros: wave_block_sums_plain(z), lambda ref: 0.0, wave_block_sums,
            SOURCE, REPLACES["sweep"], SWEEP_LOADS, ops={"f32": float(zeros.numel())},
            nbytes=zeros.numel() * zeros.element_size() + 8.0 * WAVES,
            library=lambda z=zeros: z.sum(dim=(1, 2), dtype=torch.float32),
            library_note="x.sum(dim=(1, 2), dtype=float32)", iters=20, plain_iters=5,
            check=(lambda i=ints: wave_block_sums(i),
                   lambda i=ints: wave_block_sums_plain(i))))
    return out


def run(device="cuda", seed=0) -> dict:
    """Times and errors per case (see ``timing.measure``)."""
    dev = resolve_device(device, cuda_only=True)
    gen = torch.Generator(dev).manual_seed(seed)
    with tf32_off():
        return {c.name: measure(c) for c in cases(dev, gen)}


def summary(res) -> list:
    k = res["kern"]
    lines = [f"int16 load+convert, [{B},{L}]·[{L},{B}]: max|err| = {k['max_abs_err']:.3e} "
             f"(bound {k['tol']:.3e}), kernel {k['ms'] * 1e3:.2f} µs, library "
             f"{k['library_ms'] * 1e3:.2f} µs"]
    ms = {}
    for name, size in (("int16", 2), ("f32", 4)):
        r = res[f"sweep {name}"]
        ms[name] = r["ms"]
        gbs = WAVES * ROWS * HOP * size / (r["ms"] * 1e-3) / 1e9
        lines.append(f"{name} wave sweep [{WAVES},{ROWS},{HOP}]: {r['ms']:.4f} ms = "
                     f"{gbs:.0f} GB/s (bound {r['bound_ms']:.4f} ms), library "
                     f"{r['library_ms']:.4f} ms")
    lines.append(f"int16 / f32 sweep time: {ms['int16'] / ms['f32']:.3f} (the bytes' "
                 f"ratio is 0.5)")
    return lines
