"""P7, frame rows → chunk lane blocks (``scripts/probe_chunk_relayout.py``:
``k_pass`` at :26, ``k_reshape`` at :29): on the TPU, whether re-viewing a
clip's spectrum rows [C·Nt, F] as per-chunk lane blocks [C, Nt·F/128, 128]
inside a kernel (which a featurize + select fusion needs) costs a relayout
across sublane and lane tiles.  Here: x + 1 over [512, 430, 512] f32,
written as frame rows or through the [C, nb, 128] index, whose source
offset the kernel computes with integer divisions.  On the card both write
the same bytes (a row-major reshape), so any gap is the index arithmetic.

    python -m pcaudio_torch.probes chunk_relayout
"""
from __future__ import annotations

import torch

from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.ops.kernels.featurize_probes import (
    chunk_relayout, chunk_relayout_plain)
from pcaudio_torch.probes.timing import Case, measure, tf32_off

SOURCE = "pcaudio_torch/csrc/probe_stream.cu"
REPLACES = {False: "scripts/probe_chunk_relayout.py:26",
            True: "scripts/probe_chunk_relayout.py:29"}
B, C, NT, F = 512, 43, 10, 512  # the script's shapes
NAMES = {False: "pass-through", True: "frame->chunk reshape"}
INSTRUCTION = "16-byte loads and stores, f32 adds"


def cases(dev, gen):
    x = torch.randn(B, C * NT, F, generator=gen, device=dev)
    return [Case(
        NAMES[rs], lambda rs=rs: chunk_relayout(x, C, NT, rs),
        lambda rs=rs: chunk_relayout_plain(x, C, NT, rs), lambda ref: 0.0, chunk_relayout,
        SOURCE, REPLACES[rs], INSTRUCTION, ops={"f32": float(x.numel())},
        nbytes=8.0 * x.numel(), library=lambda: x + 1.0, library_note="x + 1",
        iters=20, plain_iters=5)
        for rs in (False, True)]


def run(device="cuda", seed=0) -> dict:
    """Times and errors per case (see ``timing.measure``); exact."""
    dev = resolve_device(device, cuda_only=True)
    gen = torch.Generator(dev).manual_seed(seed)
    with tf32_off():
        return {c.name: measure(c) for c in cases(dev, gen)}


def summary(res) -> list:
    p, r = res[NAMES[False]], res[NAMES[True]]
    gbs = 8.0 * B * C * NT * F / 1e9
    return [f"{NAMES[k]} [{B},{C * NT},{F}]: {res[NAMES[k]]['ms']:.4f} ms = "
            f"{gbs / (res[NAMES[k]]['ms'] * 1e-3):.0f} GB/s (bound "
            f"{res[NAMES[k]]['bound_ms']:.4f} ms), max|err| {res[NAMES[k]]['max_abs_err']:g}"
            for k in (False, True)] + [
        f"reshape − pass-through: {(r['ms'] - p['ms']) * 1e3:+.2f} µs "
        f"({r['ms'] / p['ms']:.3f}x)"]
