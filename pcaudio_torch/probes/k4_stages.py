"""Where K4's forward spends its time, on the card: ``csrc/mha.cu``'s forward
as built, cut after the key compaction (``kStopAfter = 1``; the short-key
kernel: after loading K and V), after the staging (``2``: every key tile,
or the short kernel's query tiles, copied and waited for, nothing
computed) and after Q·Kᵀ and the softmax (``3``: P·V left out), at the
FST recipe's attends (B = 128, no mask), the 3ST recipe's (B = 16, the keys
split over blocks) and the eval shape (one expt-2 forward: B = 1024 FST
frames, rank masks at K 501 on MAB0 and PMA).  Given the source of an
earlier design (``--old-source``, e.g. the SIMT one from ``git show
705f139:pcaudio_torch/csrc/mha.cu``), it times that one whole at the same
shapes in the same process.  Each variant is its own shared library, built
with ``nvcc`` into ``build/k4_stages/``; both designs' outputs are held
against the plain version first.

    python -m pcaudio_torch.probes.k4_stages [--old-source PATH]
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from typing import Dict, List

import torch

from pcaudio_torch.eval.experiments import _ranks_desc
from pcaudio_torch.ops.kernels import _build
from pcaudio_torch.ops.kernels.mha import _sm_count, fused_mha_plain, fwd_plan
from pcaudio_torch.probes.k2_stages import Edit, stage_sources
from pcaudio_torch.probes.timing import bound_ms, card, cuda_ms

HEADS, DV = 8, 64
OUT = _build.BUILD_DIR.parent / "k4_stages"
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
NEW_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
OLD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def _build_all(sources: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """One shared library a variant, all ``nvcc`` started together."""
    procs = {}
    for name, text in sources.items():
        d = OUT / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for header in ("common.cuh", "mma.cuh"):
            (d / header).write_text((_build.CSRC / header).read_text())
        (d / "mha.cu").write_text(text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "mha.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        for line in log.splitlines():
            if ("registers" in line or "spill" in line) and name.endswith("whole"):
                print(f"[ptxas] {name}: {line.strip()}")
        fn = ctypes.CDLL(str(lib))
        fn.pcaudio_mha_fwd.argtypes = OLD_ARGS if name.startswith("old") else NEW_ARGS
        fn.pcaudio_mha_fwd.restype = ctypes.c_int
        libs[name] = fn
    return libs


def _forward(lib: ctypes.CDLL, old: bool, q, k, v, mask):
    """A launcher of one design's forward on these inputs, and its output."""
    B, N, dv = q.shape
    M = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty(B, HEADS, N, device=q.device)
    scale = 1.0 / dv ** 0.5
    mptr = None if mask is None else mask.data_ptr()
    plan = fwd_plan(B, N, M, HEADS, _sm_count(q.device.index or 0), dh=dv // HEADS)
    scratch = [None] * 3
    if not old and plan.splits > 1:
        scratch = [torch.empty(plan.splits, B, HEADS, N, device=q.device),
                   torch.empty(plan.splits, B, HEADS, N, device=q.device),
                   torch.empty(plan.splits, B, N, dv, device=q.device)]

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        if old:
            code = lib.pcaudio_mha_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), mptr,
                                       out.data_ptr(), lse.data_ptr(), B, N, M, HEADS,
                                       dv // HEADS, scale, stream)
        else:
            code = lib.pcaudio_mha_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mptr, out.data_ptr(),
                lse.data_ptr(), *(None if t is None else t.data_ptr() for t in scratch),
                B, N, M, HEADS, dv // HEADS, plan.parts, plan.rows, plan.splits, scale,
                stream)
        if code:
            raise RuntimeError(f"pcaudio_mha_fwd failed ({code})")
    return launch, out


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-source", help="an earlier design's mha.cu")
    args = ap.parse_args(argv)
    name_limit = card()
    sources = {f"new {s}": t for s, t in stage_sources(
        (_build.CSRC / "mha.cu").read_text(), CURRENT_EDITS, "csrc/mha.cu").items()}
    if args.old_source:
        with open(args.old_source) as f:
            sources["old whole"] = f.read()
    libs = _build_all(sources)
    designs = [d for d in ("new", "old") if f"{d} whole" in libs]
    gen = torch.Generator("cuda").manual_seed(0)
    for label, B, attends in SHAPES:
        total = {f"{d} {s}": 0.0 for d in designs for s in STAGES if f"{d} {s}" in libs}
        work = [0.0, 0.0, 0.0]
        for name, (N, M, keep) in attends.items():
            q, k, v, mask = _inputs(B, N, M, keep, gen)
            ref = fused_mha_plain(q, k, v, mask, HEADS, 1.0 / DV ** 0.5)
            t = {}
            for variant in total:
                launch, out = _forward(libs[variant], variant.startswith("old"), q, k, v,
                                       mask)
                if variant.endswith("whole"):
                    launch()
                    torch.cuda.synchronize()
                    err = (out - ref).abs()
                    if not bool((err <= 1e-4 * ref.abs().max() + 1e-4 * ref.abs()).all()):
                        raise AssertionError(f"{variant} at {label} {name}: max |err| "
                                             f"{err.max().item():.3e} outside K4's bound")
                t[variant] = cuda_ms(launch, 20)
                total[variant] += PER_FORWARD[name] * t[variant]
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


def _line(t: Dict[str, float]) -> str:
    parts = []
    if "new whole" in t:
        parts.append(f"new design: compaction {t['new compaction']:.4f} ms, + staging "
                     f"{t['new staging'] - t['new compaction']:.4f} ms, + Q·Kᵀ and "
                     f"softmax {t['new scores'] - t['new staging']:.4f} ms, + P·V "
                     f"{t['new whole'] - t['new scores']:.4f} ms, whole "
                     f"{t['new whole']:.4f} ms")
    if "old whole" in t:
        parts.append(f"earlier design {t['old whole']:.4f} ms")
    return "; ".join(parts)


if __name__ == "__main__":
    main()
