"""P9, stripped featurize variants (``scripts/profile_featurize_variants.py``:
``k_matmul`` at :77, ``k_matmul_f`` at :90, ``k_scratch`` at :103,
``k_full`` at :120, ``k_nozero`` at :143): on the TPU, where K3's time went
among the DFT matmuls, the VMEM scratch that shifts each clip's frames by
its trim start s0, the zero fill and the 8-way switch.  Here the P8 core
(``dft_mag2``, per-clip tiles) on 512 clips with s0 uniform in [0, 40) (the
first two clips take the edge shifts 0 and 39):

- v0, v0f (``k_matmul``, ``k_matmul_f``): frame j → output row j.  The
  script hands both f32 waves, so both convert f32 → bf16 in the kernel:
  the same function, timed twice;
- v1 (``k_scratch``): the aligned shift, row j ← frame 8·⌊(7 + s0)/8⌋ − 8 + j;
- v2 (``k_full``): row j ← frame s0 − 1 + j, rows without a frame zeroed;
- v3 (``k_nozero``): the same rows, the others not written.

The TPU's 1.8 MB scratch has no counterpart (it does not fit in shared
memory and is not needed): the shift is a per-clip row offset in the
epilogue.  Rows that v1 and v3 leave unwritten hold whatever was there, so
the check compares the rows a variant writes (``dft_written``); the bytes
of the bound count those rows.

    python -m pcaudio_torch.probes featurize_variants
"""
from __future__ import annotations

import torch

from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.ops.kernels.featurize_probes import (
    dft_mag2, dft_mag2_bound, dft_mag2_plain, dft_written)
from pcaudio_torch.probes.featurize_blockc import C, NT, case, inputs, library
from pcaudio_torch.probes.timing import measure, tf32_off

B = 512
S0_HIGH = 40
SCRIPT = "scripts/profile_featurize_variants.py"
VARIANTS = {  # case: (mode, the script's kernel line)
    "v0 matmul+sq (bf16 in)": ("direct", f"{SCRIPT}:77"),
    "v0f + f32->bf16 conv": ("direct", f"{SCRIPT}:90"),
    "v1 + scratch+aligned read": ("aligned", f"{SCRIPT}:103"),
    "v2 + zeroinit + switch": ("shift", f"{SCRIPT}:120"),
    "v3 switch, no zero-init": ("shift_nozero", f"{SCRIPT}:143"),
}


def trim_starts(dev, gen, batch):
    """s0 ~ U[0, 40) int32, the first two clips at the edges 0 and 39."""
    s0 = torch.randint(0, S0_HIGH, (batch,), generator=gen, device=dev, dtype=torch.int32)
    s0[:2] = torch.tensor([0, S0_HIGH - 1], dtype=torch.int32, device=dev)
    return s0


def masked(out, written):
    """``out`` with the rows a variant does not write set to 0."""
    return torch.where(written[..., None], out, torch.zeros_like(out))


def cases(dev, gen, batch=B):
    x3, w0, w1 = inputs(dev, gen, batch)
    s0 = trim_starts(dev, gen, batch)
    out = []
    for name, (mode, replaces) in VARIANTS.items():
        written = dft_written(x3, C, NT, mode, s0)

        def kernel(mode=mode):
            return dft_mag2(x3, w0, w1, C, NT, mode, s0)

        def plain(mode=mode):
            return dft_mag2_plain(x3, w0, w1, C, NT, mode, s0)

        out.append(case(
            name, kernel, plain, lambda ref, mode=mode: dft_mag2_bound(x3, w0, w1, C, NT,
                                                                       mode, s0),
            replaces, x3, w0, written=written, library_call=library(x3, w0, w1, mode, s0),
            check=(lambda kernel=kernel, written=written: masked(kernel(), written), plain),
            args=(x3, w0, w1, C, NT, mode, s0, 1, False)))
    return out


def run(device="cuda", seed=0) -> dict:
    """Times and errors per variant (see ``timing.measure``)."""
    dev = resolve_device(device, cuda_only=True)
    gen = torch.Generator(dev).manual_seed(seed)
    with tf32_off():
        return {c.name: measure(c) for c in cases(dev, gen)}


def summary(res) -> list:
    v0 = res["v0 matmul+sq (bf16 in)"]["ms"]
    return [f"{name:28s} {r['ms']:.3f} ms ({r['ms'] - v0:+.3f} ms vs v0), bound "
            f"{r['bound_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
            f"{r['library_ms']:.3f} ms, max|err| {r['max_abs_err']:.3e} (bound "
            f"{r['tol']:.3e})" for name, r in res.items()]
