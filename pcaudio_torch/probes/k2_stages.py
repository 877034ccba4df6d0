"""Where K2's time goes, on the card: ``csrc/select.cu`` at the bench shape
(44,032 chunks of 10 x 512 bf16 |X|² at K 128) as built, cut after its
load (``kStopAfter = 1``) and once tau is found (``kStopAfter = 2``), on
three grids: K3's grid of the bench's noise clips, a tie-heavy
grid (16 levels) and K3's grid of ragged clips (``clips.ragged_waves``;
about half the chunks invalid), after running the whole kernel on a grid
with -0.0 entries against the plain version.  Given an earlier source of
the current design (``--earlier-source``, a ``select.cu`` with its
``kStopAfter``, e.g. from ``git show REV:pcaudio_torch/csrc/select.cu``), it
cuts that one as the current source and also times the two whole kernels
in turns (earlier, current, current, earlier) on each grid.  Each variant
is its own shared library, built through ``_build.build`` (the headers
from ``csrc/``), all at once.

    python -m pcaudio_torch.probes.k2_stages [--earlier-source PATH]
"""
from __future__ import annotations

import argparse
import ctypes
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from pcaudio_torch.ops.kernels import _build
from pcaudio_torch.ops.kernels.featurize import fused_chunk_mag2
from pcaudio_torch.ops.kernels.select import exact_topk_chunks_plain
from pcaudio_torch.probes.clips import L, negzero_grid, ragged_waves
from pcaudio_torch.probes.timing import bound_ms, card, cuda_ms

B, NT, F, K = 1024, 10, 512, 128
STAGES = ("load", "tau", "whole")   # each design's cuts
Edit = Tuple[str, str]

# the design built from csrc/select.cu: its stop constant
CURRENT_EDITS: Dict[str, List[Edit]] = {
    "load": [("constexpr int kStopAfter = 0;", "constexpr int kStopAfter = 1;")],
    "tau": [("constexpr int kStopAfter = 0;", "constexpr int kStopAfter = 2;")],
}


def apply_edits(text: str, edits: List[Edit], what: str) -> str:
    """``text`` with each (old, new) replaced; raises ``ValueError`` naming
    the missing text where an edit does not apply."""
    for old, new in edits:
        if old not in text:
            raise ValueError(f"{what}: the text {old.strip()!r} is not in the source, "
                             f"so this edit does not apply")
        text = text.replace(old, new)
    return text


def stage_sources(text: str, edits: Dict[str, List[Edit]], what: str) -> Dict[str, str]:
    """The variants of one design's ``select.cu``: one per edit list (cut
    after the load, cut once tau is found, ...) and whole."""
    out = {stage: apply_edits(text, e, f"{what}, stage {stage!r}")
           for stage, e in edits.items()}
    out["whole"] = text
    return out


def variant_name(prefix: str, name: str) -> str:
    """The library name of the variant ``name``: ``prefix`` and its words."""
    return prefix + re.sub(r"[^A-Za-z0-9]+", "_", name).strip("_")


def build_variants(prefix: str, variants: Dict[str, Dict[str, str]],
                   signatures: dict) -> Dict[str, ctypes.CDLL]:
    """Each variant's sources ({file name: text}) built through
    ``_build.build`` as the library ``variant_name(prefix, name)``, all at
    once (a thread each); the libraries by variant name."""
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = pool.map(lambda kv: _build.build(variant_name(prefix, kv[0]), kv[1],
                                                signatures), variants.items())
        return dict(zip(variants, libs))


def print_ptxas(prefix: str, names, kernel: str = "") -> None:
    """ptxas' registers and spills of each variant of ``names`` (those of
    its kernels whose mangled name holds ``kernel``)."""
    for name in names:
        for line in _build.ptxas_lines(variant_name(prefix, name), kernel):
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line}")


def _select(lib: ctypes.CDLL, name: str, grid: torch.Tensor, k: int):
    n = grid.shape[0]
    vals = torch.empty(n, k, device=grid.device)
    idx = torch.zeros(n, k, dtype=torch.int32, device=grid.device)

    def launch():
        code = lib.pcaudio_topk_chunks(
            grid.data_ptr(), int(grid.dtype == torch.bfloat16), vals.data_ptr(),
            idx.data_ptr(), n, grid.shape[1] * grid.shape[2], k,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{name}: launch failed ({code})")
    return launch, vals, idx


def grids(dev) -> Dict[str, torch.Tensor]:
    """The bench shape's bf16 grids: K3 on the bench's noise clips, a
    tie-heavy grid of 16 levels, K3 on ragged clips."""
    gen = torch.Generator(dev).manual_seed(0)
    lengths = torch.full((B,), 220500, dtype=torch.int32, device=dev)
    waves = 0.1 * torch.randn(B, L, device=dev, generator=gen)
    noise = fused_chunk_mag2(waves, lengths, out_dtype=torch.bfloat16)[0]
    del waves
    rw, rl = (torch.from_numpy(a).to(dev)
              for a in ragged_waves(B, np.random.default_rng(7)))
    ragged, rmask = fused_chunk_mag2(rw, rl, out_dtype=torch.bfloat16)
    print(f"[K2 stages] ragged grid: {int(rmask.sum())} of {rmask.numel()} chunks valid")
    del rw, rl
    noise = noise.reshape(-1, NT, F)
    ties = (torch.floor(torch.rand(noise.shape, device=dev, generator=gen) * 16) / 4
            ).bfloat16()
    return {"noise": noise, "tie-heavy": ties, "ragged": ragged.reshape(-1, NT, F)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier-source",
                    help="an earlier select.cu of the current design")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    name_limit = card()
    designs = {"current": stage_sources((_build.CSRC / "select.cu").read_text(),
                                        CURRENT_EDITS, "csrc/select.cu")}
    if args.earlier_source:
        with open(args.earlier_source) as f:
            designs["earlier"] = stage_sources(f.read(), CURRENT_EDITS,
                                               args.earlier_source)
    libs = build_variants("k2_", {f"{d} {s}": {"select.cu": text}
                                  for d, srcs in designs.items()
                                  for s, text in srcs.items()},
                          {"pcaudio_topk_chunks": _build.SIGNATURES["pcaudio_topk_chunks"]})
    print_ptxas("k2_", [n for n in libs if n.endswith("whole")])

    neg = torch.from_numpy(negzero_grid(512, F, seed=3)).to(dev)
    for flat in (False, True):
        x = neg.bfloat16() if flat else neg
        rv, ri = exact_topk_chunks_plain(x, K)
        for d in designs:
            launch, v, i = _select(libs[f"{d} whole"], d, x, K)
            launch()
            torch.cuda.synchronize()
            bad = int(((i != ri).any(1) | (v != rv).any(1)).sum())
            print(f"[K2 stages] {d} design, -0.0 grid {tuple(x.shape)} {x.dtype}: "
                  + ("identical to the plain version" if not bad else
                     f"differs from the plain version on {bad} of {x.shape[0]} chunks"))
            if d == "current" and bad:
                raise AssertionError("the current K2 differs from its plain version "
                                     "on the -0.0 grid")

    for gname, grid in grids(dev).items():
        n = grid.shape[0]
        b = bound_ms({}, grid.numel() * grid.element_size() + n * K * 8.0)[0]
        for d in designs:
            t = {}
            for s in STAGES:
                launch, _, _ = _select(libs[f"{d} {s}"], f"{d} {s}", grid, K)
                t[s] = cuda_ms(launch, 10)
            print(f"[K2 stages] {d} design, {gname} grid, {n} chunks of {NT} x {F} "
                  f"bf16, K {K}: load {t['load']:.4f} ms, histogram passes "
                  f"{t['tau'] - t['load']:.4f} ms (cut at tau {t['tau']:.4f}), "
                  f"compaction {t['whole'] - t['tau']:.4f} ms, whole {t['whole']:.4f} "
                  f"ms; bound {b:.4f} ms by bytes ({name_limit})", flush=True)
        if "earlier" in designs:
            turns = [cuda_ms(_select(libs[f"{d} whole"], d, grid, K)[0], 10)
                     for d in ("earlier", "current", "current", "earlier")]
            print(f"[K2 stages] {gname} grid, whole kernel in turns (earlier, current, "
                  f"current, earlier): {' / '.join(f'{t:.4f}' for t in turns)} ms "
                  f"({name_limit})", flush=True)
        del grid
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
