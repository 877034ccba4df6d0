"""P1, the batched dot (``scripts/probe_batched_dot.py:9``, ``pallas_call``
at :24): on the TPU, whether Mosaic lowers a batched ``dot_general``
inside a kernel (K1's eight dh = 8 heads as one batched product).  Here:
what one batched [8, 512, 64] · [8, 64, 128] bf16 → f32 product costs as
one hand-written ``wgmma`` kernel, against ``torch.bmm``.

    python -m pcaudio_torch.probes batched_dot
"""
from __future__ import annotations

import torch

from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.ops.kernels.probes import (
    WGMMA_BF16, matmul_bound, probe_matmul, probe_matmul_plain)
from pcaudio_torch.probes.timing import Case, measure, tf32_off

REPLACES = "scripts/probe_batched_dot.py:9"
SOURCE = "pcaudio_torch/csrc/probe_mma.cu"
B, M, K, N = 8, 512, 64, 128  # the script's shapes


def cases(dev, gen):
    a = torch.randn(B, M, K, generator=gen, device=dev).bfloat16()
    b = torch.randn(B, K, N, generator=gen, device=dev).bfloat16()
    return [Case(
        "batched_dot", lambda: probe_matmul(a, b), lambda: probe_matmul_plain(a, b),
        lambda ref: matmul_bound(a, b), probe_matmul, SOURCE, REPLACES, WGMMA_BF16,
        ops={"bf16": 2 * B * M * K * N}, nbytes=2 * (a.numel() + b.numel()) + 4 * B * M * N,
        library=lambda: torch.bmm(a, b), library_note="torch.bmm in bf16 (bf16 out)",
        iters=50, plain_iters=50, args=(a, b))]


def run(device="cuda", seed=0) -> dict:
    """Times and errors per case (see ``timing.measure``)."""
    dev = resolve_device(device, cuda_only=True)
    gen = torch.Generator(dev).manual_seed(seed)
    with tf32_off():
        return {c.name: measure(c) for c in cases(dev, gen)}


def summary(res) -> list:
    r = res["batched_dot"]
    return [f"batched [{B},{M},{K}]·[{B},{K},{N}] bf16 → f32: max |err| vs f32 "
            f"{r['max_abs_err']:.3e}, kernel {r['ms'] * 1e3:.2f} µs, torch.bmm "
            f"{r['library_ms'] * 1e3:.2f} µs ({r['instruction']})"]
