"""Where K4's forward spends its time, on the card: ``csrc/mha.cu``'s forward
as built, cut after the key compaction (``kStopAfter = 1``; the short-key
kernel: after loading K and V), after the staging (``2``: every key tile,
or the short kernel's query tiles, copied and waited for, nothing
computed) and after Q·Kᵀ and the softmax (``3``: P·V left out), at the
FST recipe's attends (B = 128, no mask), the 3ST recipe's (B = 16, the keys
split over blocks) and the eval shape (one expt-2 forward: B = 1024 FST
frames, rank masks at K 501 on MAB0 and PMA).

Then the backward at the FST and 3ST step shapes: the planned one-pass
kernels (``ops/kernels/mha.py::bwd_plan``) beside their bound (bytes, the
3xTF32 products with S recomputed, the exps).

Each variant is its own shared library, built through ``_build.build``
(the headers from ``csrc/``), all at once; the whole kernel's outputs are
held against the plain version first.

    python -m pcaudio_torch.probes.k4_stages
"""
from __future__ import annotations

import ctypes
from typing import Dict, List

import torch

from pcaudio_torch.eval.experiments import _ranks_desc
from pcaudio_torch.ops.kernels import _build
from pcaudio_torch.ops.kernels.mha import (
    BWD_KINDS, _sm_count, bwd_plan, fused_mha_bwd_plain, fused_mha_plain, fwd_plan)
from pcaudio_torch.probes.k2_stages import Edit, build_variants, print_ptxas, stage_sources
from pcaudio_torch.probes.timing import bound_ms, card, cuda_ms

HEADS, DV = 8, 64
STAGES = ("compaction", "staging", "scores", "whole")
CURRENT_EDITS: Dict[str, List[Edit]] = {
    stage: [("constexpr int kStopAfter = 0;", f"constexpr int kStopAfter = {n};")]
    for n, stage in enumerate(STAGES[:-1], 1)}
# (name, B, {attend: (queries, keys, rank-mask K or None)}, attends a forward)
FST = {"MAB0": (64, 1025, None), "MAB1": (1025, 64, None), "PMA": (1, 1025, None)}
ST3 = {"MAB0": (64, 5120, None), "MAB1": (5120, 64, None), "PMA": (1, 5120, None)}
EVAL = {"MAB0": (64, 1025, 501), "MAB1": (1025, 64, None), "PMA": (1, 1025, 501)}
SHAPES = (("FST step", 128, FST), ("3ST step", 16, ST3), ("eval (expt 2, K 501)", 1024, EVAL))
PER_FORWARD = {"MAB0": 2, "MAB1": 2, "PMA": 1}   # two ISABs, one PMA


def _forward(lib: ctypes.CDLL, q, k, v, mask):
    """A launcher of one variant's forward on these inputs, its output and
    its lse."""
    B, N, dv = q.shape
    M = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty(B, HEADS, N, device=q.device)
    scale = 1.0 / dv ** 0.5
    mptr = None if mask is None else mask.data_ptr()
    plan = fwd_plan(B, N, M, HEADS, _sm_count(q.device.index or 0), dh=dv // HEADS)
    scratch = [None] * 3
    if plan.splits > 1:
        scratch = [torch.empty(plan.splits, B, HEADS, N, device=q.device),
                   torch.empty(plan.splits, B, HEADS, N, device=q.device),
                   torch.empty(plan.splits, B, N, dv, device=q.device)]

    def launch():
        code = lib.pcaudio_mha_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mptr, out.data_ptr(),
            lse.data_ptr(), *(None if t is None else t.data_ptr() for t in scratch),
            B, N, M, HEADS, dv // HEADS, plan.parts, plan.rows, plan.splits, scale,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"pcaudio_mha_fwd failed ({code})")
    return launch, out, lse


def _backward(lib: ctypes.CDLL, q, k, v, out, lse, g):
    """A launcher of the backward (no mask) on these inputs, its planned
    route, and its (dq, dk, dv)."""
    B, N, dv = q.shape
    M = k.shape[1]
    scale = 1.0 / dv ** 0.5
    grads = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
    delta = torch.empty_like(lse)
    plan = bwd_plan(B, N, M, HEADS, _sm_count(q.device.index or 0), dv // HEADS)
    parts = [None, None]
    if plan.splits > 1:
        shape = (plan.splits,) + tuple((q if plan.kind == "fewq" else k).shape)
        parts = [torch.empty(shape, device=q.device), torch.empty(shape, device=q.device)]
    ptrs = [t.data_ptr() for t in (q, k, v)] + [None] + [
        t.data_ptr() for t in (out, lse, g, delta, *grads)]

    def launch():
        code = lib.pcaudio_mha_bwd(
            *ptrs, *(None if t is None else t.data_ptr() for t in parts), B, N, M,
            HEADS, dv // HEADS, BWD_KINDS.index(plan.kind), plan.splits, scale,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"pcaudio_mha_bwd failed ({code})")
    return launch, grads


def bwd_work(B, N, M, heads=HEADS, dv=DV):
    """(exps, 3xTF32 flops, bytes) of one unmasked attend's backward: an exp
    a pair and head; five products (S recomputed, dP, dV, dK, dQ) of 2·dh
    flops a pair and head, three passes each; q, k, v, out, g and lse read
    once, dq, dk, dv written once."""
    pairs = float(B) * N * M
    return (pairs * heads, 3 * 5 * 2.0 * dv * pairs,
            4.0 * (4 * B * N * dv + 4 * B * M * dv + B * heads * N))


def bwd_parts(exps, flops, nb):
    """The three times that bound K4's backward, as a line."""
    return (f"bytes {bound_ms({}, nb)[0]:.4f} ms, 3xTF32 products "
            f"{bound_ms({'tf32': flops}, 0)[0]:.4f} ms, exps "
            f"{bound_ms({'sfu': exps}, 0)[0]:.4f} ms")


def _inputs(B, N, M, keep, gen):
    q, k, v = (torch.randn(B, r, DV, device="cuda", generator=gen) for r in (N, M, M))
    mask = None
    if keep is not None:
        mask = _ranks_desc(torch.rand(B, M, device="cuda", generator=gen)) < keep
    return q, k, v, mask


def _work(B, N, M, keep):
    """(exps, 3xTF32 flops, bytes) of one attend, valid keys only."""
    valid = M if keep is None else keep
    nb = 4.0 * (2 * B * N * DV + B * HEADS * N + 2 * B * valid * DV)
    return (float(B) * HEADS * N * valid, 3 * 4.0 * B * N * valid * DV,
            nb + (0 if keep is None else B * M))


def main() -> None:
    name_limit = card()
    libs = build_variants(
        "k4_", {stage: {"mha.cu": text} for stage, text in stage_sources(
            (_build.CSRC / "mha.cu").read_text(), CURRENT_EDITS, "csrc/mha.cu").items()},
        {n: _build.SIGNATURES[n] for n in ("pcaudio_mha_fwd", "pcaudio_mha_bwd")})
    print_ptxas("k4_", ["whole"])
    gen = torch.Generator("cuda").manual_seed(0)
    for label, B, attends in SHAPES:
        total = dict.fromkeys(STAGES, 0.0)
        work = [0.0, 0.0, 0.0]
        for name, (N, M, keep) in attends.items():
            q, k, v, mask = _inputs(B, N, M, keep, gen)
            ref = fused_mha_plain(q, k, v, mask, HEADS, 1.0 / DV ** 0.5)
            t = {}
            for stage in STAGES:
                launch, out, _ = _forward(libs[stage], q, k, v, mask)
                if stage == "whole":
                    launch()
                    torch.cuda.synchronize()
                    err = (out - ref).abs()
                    if not bool((err <= 1e-4 * ref.abs().max() + 1e-4 * ref.abs()).all()):
                        raise AssertionError(f"K4 at {label} {name}: max |err| "
                                             f"{err.max().item():.3e} outside K4's bound")
                t[stage] = cuda_ms(launch, 20)
                total[stage] += PER_FORWARD[name] * t[stage]
            w = _work(B, N, M, keep)
            work = [a + PER_FORWARD[name] * b for a, b in zip(work, w)]
            b = bound_ms({"sfu": w[0], "tf32": w[1]}, w[2])
            print(f"[K4 stages] {label} {name} B={B} {N}x{M}"
                  f"{'' if keep is None else f' rank mask K={keep}'}: " + _line(t)
                  + f"; bound {b[0]:.4f} ms by {b[1]} ({name_limit})", flush=True)
            del q, k, v, mask, ref
            torch.cuda.empty_cache()
        b = bound_ms({"sfu": work[0], "tf32": work[1]}, work[2])
        print(f"[K4 stages] {label}, one forward's five attends: " + _line(total)
              + f"; bound {b[0]:.4f} ms by {b[1]} (exps "
              f"{bound_ms({'sfu': work[0]}, 0)[0]:.4f}, 3xTF32 products "
              f"{bound_ms({'tf32': work[1]}, 0)[0]:.4f}, bytes "
              f"{bound_ms({}, work[2])[0]:.4f}) ({name_limit})", flush=True)
    backward_times(libs["whole"], gen, name_limit)


def backward_times(lib, gen, name_limit) -> None:
    """The backward at the FST and 3ST step shapes, held against the plain
    backward within K4's bound first, on the forward's out and lse."""
    for label, B, attends in SHAPES[:2]:
        total = 0.0
        work = [0.0, 0.0, 0.0]
        for name, (N, M, _) in attends.items():
            q, k, v, _ = _inputs(B, N, M, None, gen)
            g = torch.randn(q.shape, device="cuda", generator=gen)
            fwd, out, lse = _forward(lib, q, k, v, None)
            fwd()
            ref = fused_mha_bwd_plain(q, k, v, None, g, HEADS, 1.0 / DV ** 0.5)
            launch, grads = _backward(lib, q, k, v, out, lse, g)
            launch()
            torch.cuda.synchronize()
            for got, r, d in zip(grads, ref, ("dq", "dk", "dv")):
                err = (got - r).abs()
                if not bool((err <= 1e-4 * r.abs().max() + 1e-4 * r.abs()).all()):
                    raise AssertionError(f"K4's backward at {label} {name}: {d} max |err| "
                                         f"{err.max().item():.3e} outside K4's bound")
            t = cuda_ms(launch, 20)
            total += PER_FORWARD[name] * t
            w = bwd_work(B, N, M)
            work = [a + PER_FORWARD[name] * b for a, b in zip(work, w)]
            plan = bwd_plan(B, N, M, HEADS, _sm_count(0))
            b = bound_ms({"sfu": w[0], "tf32": w[1]}, w[2])
            print(f"[K4 bwd] {label} {name} B={B} {N}x{M} ({plan.kind}, {plan.splits} "
                  f"split{'s' if plan.splits > 1 else ''}): {t:.4f} ms; bound {b[0]:.4f} "
                  f"ms by {b[1]} ({name_limit})", flush=True)
            del q, k, v, g, out, lse, ref
            torch.cuda.empty_cache()
        b = bound_ms({"sfu": work[0], "tf32": work[1]}, work[2])
        print(f"[K4 bwd] {label}, one step's five attends: {total:.4f} ms; bound "
              f"{b[0]:.4f} ms by {b[1]} ({bwd_parts(*work)}) ({name_limit})", flush=True)


def _line(t: Dict[str, float]) -> str:
    return (f"compaction {t['compaction']:.4f} ms, + staging "
            f"{t['staging'] - t['compaction']:.4f} ms, + Q·Kᵀ and softmax "
            f"{t['scores'] - t['staging']:.4f} ms, + P·V {t['whole'] - t['scores']:.4f} "
            f"ms, whole {t['whole']:.4f} ms")


if __name__ == "__main__":
    main()
