"""P2, int8 tensor-core products (``scripts/probe_int8_matmul.py``: ``kern``
at :21, ``make_big`` at :44, ``make`` at :85): on the TPU, whether int8
``dot_general`` with int32 accumulation lowers, and its throughput against
bf16.  Here, with ``wgmma`` m64n128k32 s8 and m64n128k16 bf16:

- small: [128, 128] · [128, 128] int8 → int32, exact;
- big: Σ_{i<16} A[8i : 8i+1024] · B, [1024, 512] · [512, 512], 256 repeats;
- attend: the same at [1024, 128] · [128, 128], 64 windows, 256 repeats;

int8 → int32 and bf16 → f32 on operands in [-4, 4), so both are exact.

    python -m pcaudio_torch.probes int8_matmul
"""
from __future__ import annotations

import torch

from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.ops.kernels.probes import (
    WGMMA_BF16, WGMMA_S8, probe_matmul, probe_matmul_plain)
from pcaudio_torch.probes.timing import (
    PEAK_OPS_PER_S, Case, measure, tf32_off)

SOURCE = "pcaudio_torch/csrc/probe_mma.cu"
REPLACES = {"small": "scripts/probe_int8_matmul.py:21",
            "big": "scripts/probe_int8_matmul.py:44",
            "attend": "scripts/probe_int8_matmul.py:85"}
GRID, SHIFT = 256, 8
SHAPES = {"big": (1024, 512, 512, 16), "attend": (1024, 128, 128, 64)}  # M, K, N, reps


def _library(a, b, reps, dt):
    """One library call per repeat on the windows laid side by side along K
    ([M, reps·K] · [reps·K, N] is Σ_i A_i · B), ``GRID`` calls."""
    M = a.shape[0] - SHIFT * (reps - 1)
    a_cat = torch.cat([a[i * SHIFT: i * SHIFT + M] for i in range(reps)], 1)
    b_cat = b.repeat(reps, 1)
    mm = torch._int_mm if dt == torch.int8 else torch.matmul

    def call():
        for _ in range(GRID):
            mm(a_cat, b_cat)
    return call


def cases(dev, gen):
    out = []
    sa, sb = (torch.randint(-127, 127, (128, 128), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
    out.append(Case(
        "small int8", lambda: probe_matmul(sa, sb), lambda: probe_matmul_plain(sa, sb),
        lambda ref: 0.0, probe_matmul, SOURCE, REPLACES["small"], WGMMA_S8,
        ops={"int8": 2 * 128 ** 3}, nbytes=2 * 128 ** 2 + 4 * 128 ** 2,
        library=lambda: torch._int_mm(sa, sb), library_note="torch._int_mm",
        iters=50, plain_iters=50, args=(sa, sb)))
    for kind, (M, K, N, reps) in SHAPES.items():
        for dt, name, instr in ((torch.int8, "int8", WGMMA_S8), (torch.bfloat16, "bf16", WGMMA_BF16)):
            a = torch.randint(-4, 4, (M + SHIFT * reps, K), generator=gen, device=dev).to(dt)
            b = torch.randint(-4, 4, (K, N), generator=gen, device=dev).to(dt)
            a = a[: M + SHIFT * (reps - 1)]  # the rows the windows read
            kern = (lambda a=a, b=b, reps=reps:
                    probe_matmul(a, b, reps=reps, shift=SHIFT, repeats=GRID))
            plain = (lambda a=a, b=b, reps=reps:
                     probe_matmul_plain(a, b, reps=reps, shift=SHIFT, repeats=GRID))
            es = a.element_size()
            out.append(Case(
                f"{kind} {name}", kern, plain, lambda ref: 0.0, probe_matmul, SOURCE,
                REPLACES[kind], instr, ops={name: 2.0 * GRID * reps * M * K * N},
                nbytes=es * (a.numel() + b.numel()) + 4 * M * N,
                library=_library(a, b, reps, dt),
                library_note=(f"{GRID} x torch.{'_int_mm' if dt == torch.int8 else 'matmul'}"
                              f" of the {reps} windows side by side along K"),
                iters=5, plain_iters=1, args=(a, b, reps, SHIFT, GRID)))
    return out


def run(device="cuda", seed=0) -> dict:
    """Times and errors per case (see ``timing.measure``); all exact."""
    dev = resolve_device(device, cuda_only=True)
    gen = torch.Generator(dev).manual_seed(seed)
    with tf32_off():
        return {c.name: measure(c) for c in cases(dev, gen)}


def summary(res) -> list:
    lines = [f"int8 dot 128x128: max|err| = {res['small int8']['max_abs_err']:g}"]
    for kind, (M, K, N, reps) in SHAPES.items():
        for name in ("int8", "bf16"):
            r = res[f"{kind} {name}"]
            tops = 2.0 * GRID * reps * M * K * N / (r["ms"] * 1e-3) / 1e12
            peak = PEAK_OPS_PER_S[name] / 1e12
            lines.append(f"{kind} {name} [{M},{K}]·[{K},{N}] x{reps} x{GRID}: "
                         f"{r['ms']:.3f} ms = {tops:.1f} TOP/s of {peak:,.0f} "
                         f"({100 * tops / peak:.1f} %), library {r['library_ms']:.3f} ms "
                         f"({r['instruction']})")
        ratio = res[f"{kind} bf16"]["ms"] / res[f"{kind} int8"]["ms"]
        lines.append(f"{kind}: int8 is {ratio:.2f}x faster than bf16")
    return lines
