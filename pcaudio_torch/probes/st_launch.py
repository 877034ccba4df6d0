"""P5, K1 relaunched at the v6 probes' shapes (``scripts/probe_v6_bare.py:61``,
``probe_v6_wjit.py:67``, ``probe_v6_pack.py:69``): on the TPU, what the v6
fused-ST ``pallas_call`` costs with its operands pre-packed, with its
weights packed inside every call, and with its pair-packing glue.  Here
the port's K1 (``csrc/fused_st.cu``, no new kernel) on 5,504 clouds of 128
bf16 points x 3, all valid, a full-width 3ST (dim 64, 64 inducing points,
8 heads, 10 classes) with weights drawn from the generator, in three
modes:

- ``bare``: one launch on a weight buffer packed once (the script's
  pre-packed operands);
- ``wjit``: the weights repacked (``_packed_weights``, bf16 B fragments
  and f32 biases) before every launch;
- ``pack``: the whole ``fused_st_forward`` wrapper, checks and all.  The
  port has no v6 pair-packing (ROADMAP "Not ported"), so this measures the
  port's own glue, not the script's pair concatenation.

    python -m pcaudio_torch.probes st_launch
"""
from __future__ import annotations

import torch

from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.nn import ST
from pcaudio_torch.ops.kernels.fused_st import (
    _packed_weights, fused_st_forward, fused_st_forward_plain, launch_packed)
from pcaudio_torch.probes.timing import Case, measure, tf32_off

REPLACES = {"bare": "scripts/probe_v6_bare.py:61", "wjit": "scripts/probe_v6_wjit.py:67",
            "pack": "scripts/probe_v6_pack.py:69"}
SOURCE = "pcaudio_torch/csrc/fused_st.cu"
INSTRUCTION = "bf16 mma.sync (m16n8k16 projections and P.V, m16n8k8 scores), SFU ex2"
B, K, DIN, DV, M, H, NCLS = 5504, 128, 3, 64, 64, 8, 10
# K1's bound against its plain version, atol = rtol: both round to bf16 at
# the same places, but a value near a rounding boundary can round either
# way after another summation order or the online softmax's rescaling
K1_TOL = 1e-2


def st_flops(n_points, dim_input, dim_hidden, num_inds, dim_output) -> int:
    """FLOPs of one ST forward on one cloud (one multiply-add = 2 FLOPs;
    biases and softmax left out): ISAB x 2 + PMA + Dense, as
    ``pcaudio/bench/flops_calc.py::st_flops`` counts them."""
    def dense(n, i, o):
        return 2 * n * i * o

    def mab(nq, nkv, dq, dk, dv):
        return (dense(nq, dq, dv) + 2 * dense(nkv, dk, dv) + 4 * nq * nkv * dv
                + dense(nq, dv, dv))

    def isab(n, din, dout):
        return mab(num_inds, n, dout, din, dout) + mab(n, num_inds, din, dout, dout)

    return (isab(n_points, dim_input, dim_hidden)
            + isab(n_points, dim_hidden, dim_hidden)
            + mab(1, n_points, dim_hidden, dim_hidden, dim_hidden)
            + dense(1, dim_hidden, dim_output))


def st_exps(n_points, num_inds, num_heads) -> int:
    """Softmax exps of one ST forward on one cloud: MAB0 (inducing queries
    over the points) and MAB1 (points over the inducing rows) in each of
    the two ISABs, and the PMA's seed over the points."""
    return (2 * (num_inds * num_heads * n_points + n_points * num_heads * num_inds)
            + num_heads * n_points)


def seeded_3st(dev, gen) -> ST:
    """Full-width 3ST, each weight U(±1/√fan_in) from ``gen``."""
    model = ST(dim_input=DIN, dim_output=NCLS, num_inds=M, dim_hidden=DV,
               num_heads=H).to(dev).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_((2 * torch.rand(p.shape, generator=gen, device=dev) - 1)
                    / p.shape[-1] ** 0.5)
    return model


def cases(dev, gen):
    model = seeded_3st(dev, gen)
    pts = torch.randn(B, K, DIN, generator=gen, device=dev).bfloat16()
    out = torch.empty(B, NCLS, device=dev)
    w = _packed_weights(model, dev)

    def bare():
        launch_packed(pts, None, w, out, M)
        return out

    def wjit():
        model._fused_st_pack = None  # repack on this call
        launch_packed(pts, None, _packed_weights(model, dev), out, M)
        return out

    modes = {"bare": bare, "wjit": wjit, "pack": lambda: fused_st_forward(model, pts)}
    return [Case(name, fn, lambda: fused_st_forward_plain(model, pts),
                 lambda ref: K1_TOL + K1_TOL * ref.abs(),
                 fused_st_forward, SOURCE, REPLACES[name], INSTRUCTION,
                 ops={"bf16": float(B * st_flops(K, DIN, DV, M, NCLS)),
                      "sfu": float(B * st_exps(K, M, H))},
                 nbytes=(2 * pts.numel() + 4 * B * NCLS
                         + sum(t.numel() * t.element_size() for t in w)),
                 iters=10, plain_iters=2)
            for name, fn in modes.items()]


def run(device="cuda", seed=0) -> dict:
    """Times and errors per mode (see ``timing.measure``)."""
    dev = resolve_device(device, cuda_only=True)
    gen = torch.Generator(dev).manual_seed(seed)
    with tf32_off():
        return {c.name: measure(c) for c in cases(dev, gen)}


def summary(res) -> list:
    return [f"{m} ({REPLACES[m].split('/')[-1]}): {res[m]['ms']:.3f} ms/batch "
            f"{res[m]['ms'] * 1e3 / B:.3f} us/chunk, plain {res[m]['plain_ms']:.3f} ms, "
            f"bound {res[m]['bound_ms']:.3f} ms by {res[m]['bound_by']}"
            for m in ("bare", "wjit", "pack")]
