"""P3, the int8 attend (``scripts/probe_int8_attend.py:53``, ``make_kernel``;
``pallas_call`` at :105): on the TPU, whether the v6 attend stage can run in
int8 end to end inside the kernel (in-kernel quantisation, int8 products
with int32 accumulation, f32 dequantisation), and what that costs against
bf16 at the serving shapes: logits [1024, 128] · [128, 128]ᵀ then
A·V [1024, 128] · [128, 128], 8 windows a grid step, 1024 steps.

Here both modes run the script's arithmetic in one ``wgmma`` kernel
(``csrc/probe_attend.cu``); ``F.scaled_dot_product_attention`` in bf16 is
timed beside the bf16 mode (at this probe's scale, |logit| about 2.5
standard deviations, the ±50 clip is never reached).

    python -m pcaudio_torch.probes int8_attend
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.ops.kernels.probes import (
    ATTEND_DV, ATTEND_KEYS, WGMMA_ATTEND_BF16, WGMMA_ATTEND_S8, attend_bound, probe_attend,
    probe_attend_plain)
from pcaudio_torch.probes.timing import Case, measure, tf32_off

REPLACES = "scripts/probe_int8_attend.py:53"
SOURCE = "pcaudio_torch/csrc/probe_attend.cu"
P, K, DV2 = 8, ATTEND_KEYS, ATTEND_DV  # pairs per grid step, keys, width
ROWS = 2 * 8 * 64                      # 2·h·m query rows
GRID = 1024
ATTENDS = GRID * P


def _sdpa(iq, kmat):
    """One ``scaled_dot_product_attention`` call over all 8,192 attends (the
    query repeated, keys = values = the windows), summed over the attends."""
    win = kmat[: (2 * P - 1) * K].reshape(2 * P - 1, K, DV2)
    idx = torch.tensor([(g % P) + p for g in range(GRID) for p in range(P)],
                       device=kmat.device)
    kv = win[idx].bfloat16()[:, None]                      # [8192, 1, K, dv]
    q = iq.bfloat16().expand(ATTENDS, 1, ROWS, DV2).contiguous()
    return lambda: F.scaled_dot_product_attention(q, kv, kv, scale=0.125).sum(
        (0, 1), dtype=torch.float32)


def cases(dev, gen):
    iq = 1.5 * torch.randn(ROWS, DV2, generator=gen, device=dev)
    kmat = 1.2 * torch.randn(2 * P * K, DV2, generator=gen, device=dev)
    out = []
    for mode, instr in (("bf16", WGMMA_ATTEND_BF16), ("int8", WGMMA_ATTEND_S8)):
        mac = 2.0 * ATTENDS * ROWS * K * DV2
        out.append(Case(
            mode, lambda mode=mode: probe_attend(iq, kmat, mode, P, K, GRID),
            lambda mode=mode: probe_attend_plain(iq, kmat, mode, P, K, GRID),
            lambda ref, mode=mode: attend_bound(iq, kmat, mode, P, K, GRID),
            probe_attend, SOURCE, REPLACES, instr,
            ops={mode: 2 * mac, "sfu": float(ATTENDS * ROWS * K)},
            nbytes=4 * (iq.numel() + kmat.numel() + ROWS * DV2),
            library=_sdpa(iq, kmat) if mode == "bf16" else None,
            library_note=("F.scaled_dot_product_attention, bf16, all attends in one "
                          "call, summed" if mode == "bf16" else "none"),
            iters=5, plain_iters=1, args=(iq, kmat, mode, P, K, GRID)))
    return out


def run(device="cuda", seed=0) -> dict:
    """Times and errors per mode (see ``timing.measure``), and the int8
    kernel's relative deviation from the bf16 kernel, as the script prints."""
    dev = resolve_device(device, cuda_only=True)
    gen = torch.Generator(dev).manual_seed(seed)
    with tf32_off():
        res = {c.name: measure(c) for c in cases(dev, gen)}
    ref, q = res["bf16"]["out"], res["int8"]["out"]
    res["int8"]["rel_vs_bf16"] = ((q - ref).abs().max() / (ref.abs().max() + 1e-9)).item()
    return res


def summary(res) -> list:
    lines = [f"{m}: {res[m]['ms']:.3f} ms = {res[m]['ms'] * 1e3 / ATTENDS:.3f} µs/attend "
             f"(bound {res[m]['bound_ms']:.3f} ms by {res[m]['bound_by']}; "
             f"{res[m]['instruction']})" for m in ("bf16", "int8")]
    lines.append(f"sdpa bf16: {res['bf16']['library_ms']:.3f} ms = "
                 f"{res['bf16']['library_ms'] * 1e3 / ATTENDS:.3f} µs/attend")
    lines.append(f"int8 vs bf16: max rel err {res['int8']['rel_vs_bf16']:.4f}")
    return lines
