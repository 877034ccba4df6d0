"""P4, 64- vs 128-wide operands (``scripts/probe_lane_width.py``:
``chain_kernel`` at :28, ``vpu_kernel`` at :65): on the TPU, whether a
[n, 64] · [64, 64] product or a 64-lane exp costs as much as the 128-wide
one, i.e. whether two clouds side by side are free.  Here: 64 dependent
products x ← bf16(x·w) of [1024, d] · [d, d] (``wgmma`` m64ndk16, each
warpgroup keeping a chain's 64 rows in registers), and 64 steps of
x ← exp(0.5·x) on [1024, d] f32, d ∈ {64, 128}, 256 repeats each.

The times are taken on the script's values: neither the tensor cores nor
the exp units take a shortcut on them.  But the script's w = N(0, 1)/d
shrinks x by about √d a product, so x is zero in bf16 after about 40
products, and exp(x/2) > x for every x, so the exp chain overflows to +inf
within about 10 steps: on those outputs a wrong kernel would pass.  So the
check runs at the same shapes on other inputs: the chain held equal on two
pairs, a signed permutation w (64 exact products that move x's values)
and ``rounding_chain_inputs`` (64 steps that each round to bf16, their
sums still exact), the exp chain for ``CHECK_EXP_REPS`` steps, while it
is still finite.

    python -m pcaudio_torch.probes lane_width
"""
from __future__ import annotations

import torch

from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.ops.kernels.probes import (
    EXP_SFU, WGMMA_CHAIN, exp_chain_bound, probe_chain, probe_chain_plain,
    probe_exp_chain, probe_exp_chain_plain, rounding_chain_inputs, signed_permutation)
from pcaudio_torch.probes.timing import Case, measure, tf32_off

SOURCE = "pcaudio_torch/csrc/probe_mma.cu"
N_ROWS, REPS, GRID = 1024, 64, 256
WIDTHS = (64, 128)
CHECK_EXP_REPS = 2  # N(0, 1) inputs overflow f32 at the third step


def chain_check(fn, checks):
    """``fn`` (a chain's call) on each argument tuple of ``checks``, the
    outputs stacked by rows."""
    return torch.cat([fn(*args) for args in checks])


def cases(dev, gen):
    out = []
    for d in WIDTHS:
        x = torch.randn(N_ROWS, d, generator=gen, device=dev).bfloat16()
        w = (torch.randn(d, d, generator=gen, device=dev) / d).bfloat16()
        checks = ((x, signed_permutation(d, gen, dev), REPS, GRID),
                  (*rounding_chain_inputs(N_ROWS, d, gen, dev), REPS, GRID))
        out.append(Case(
            f"chain d={d}", lambda x=x, w=w: probe_chain(x, w, REPS, GRID),
            lambda x=x, w=w: probe_chain_plain(x, w, REPS, GRID),
            lambda ref: 0.0, probe_chain, SOURCE,
            "scripts/probe_lane_width.py:28", WGMMA_CHAIN,
            ops={"bf16": 2.0 * GRID * REPS * N_ROWS * d * d},
            nbytes=2 * (x.numel() + w.numel()) + 4 * x.numel(), iters=10, plain_iters=2,
            check=(lambda checks=checks: chain_check(probe_chain, checks),
                   lambda checks=checks: chain_check(probe_chain_plain, checks)),
            args=(x, w, REPS, GRID), check_args=checks))
    for d in WIDTHS:
        x = torch.randn(N_ROWS, d, generator=gen, device=dev)
        out.append(Case(
            f"exp d={d}", lambda x=x: probe_exp_chain(x, REPS, GRID),
            lambda x=x: probe_exp_chain_plain(x, REPS, GRID), exp_chain_bound,
            probe_exp_chain, SOURCE, "scripts/probe_lane_width.py:65", EXP_SFU,
            ops={"sfu": float(GRID * REPS * x.numel())}, nbytes=8 * x.numel(),
            iters=10, plain_iters=2,
            check=(lambda x=x: probe_exp_chain(x, CHECK_EXP_REPS, GRID),
                   lambda x=x: probe_exp_chain_plain(x, CHECK_EXP_REPS, GRID))))
    return out


def run(device="cuda", seed=0) -> dict:
    """Times and errors per case (see ``timing.measure``)."""
    dev = resolve_device(device, cuda_only=True)
    gen = torch.Generator(dev).manual_seed(seed)
    with tf32_off():
        return {c.name: measure(c) for c in cases(dev, gen)}


def summary(res) -> list:
    lines = []
    for kind, label in (("chain", f"chain [{N_ROWS},d]@[d,d] x{REPS} x{GRID}"),
                        ("exp", f"exp chain [{N_ROWS},d] x{REPS} x{GRID}")):
        t64, t128 = res[f"{kind} d=64"]["ms"], res[f"{kind} d=128"]["ms"]
        work = 4.0 if kind == "chain" else 2.0
        lines.append(f"{label}: d=64 {t64:.3f} ms, d=128 {t128:.3f} ms, ratio "
                     f"d=128/d=64 {t128 / t64:.2f} (the work's ratio is {work:g}; 1.0 "
                     f"would make 64-wide operands cost as much as 128-wide) "
                     f"({res[f'{kind} d=64']['instruction']})")
    return lines
