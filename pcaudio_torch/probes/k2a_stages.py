"""Where K2a's time goes, on the card: ``csrc/approx_select.cu`` at the
bench shape (44,032 rows of 10 x 512 bf16 |X|² at K 128) as built and cut
after its load (``kStopAfter = 1``), after the window maxima (2), once tau
is found (3) and after the compaction (4), on K2's three grids (the bench's
noise, a tie-heavy grid, ragged clips: ``k2_stages.grids``) at the plans of
recall 0.8, 0.9, 0.95 and 0.99, with K2 timed beside it.  Each variant is
its own shared library, built through ``_build.build`` (the headers from
``csrc/``), all at once; the whole kernel is first held against its plain
version.

    python -m pcaudio_torch.probes.k2a_stages
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from pcaudio_torch.ops.kernels import _build
from pcaudio_torch.ops.kernels.approx_select import (
    approx_topk_chunks_plain, approx_topk_plan)
from pcaudio_torch.ops.kernels.select import exact_topk_chunks
from pcaudio_torch.probes.k2_stages import K, apply_edits, build_variants, grids, print_ptxas
from pcaudio_torch.probes.timing import bound_ms, card, cuda_ms

STOP = "constexpr int kStopAfter = 0;"
STAGES = {"load": 1, "windows": 2, "tau": 3, "compaction": 4, "whole": 0}
RECALLS = (0.8, 0.9, 0.95, 0.99)


def stage_sources(text: str) -> Dict[str, str]:
    """``approx_select.cu`` cut at each stage (and whole)."""
    return {name: apply_edits(text, [(STOP, f"constexpr int kStopAfter = {n};")],
                              f"approx_select.cu, stage {name!r}") if n else text
            for name, n in STAGES.items()}


def _select(lib: ctypes.CDLL, keys: torch.Tensor, k: int, recall: float):
    R, N = keys.shape
    M, r = approx_topk_plan(N, k, recall)
    vals = torch.empty(R, k, device=keys.device)
    idx = torch.zeros(R, k, dtype=torch.int32, device=keys.device)

    def launch():
        code = lib.pcaudio_approx_topk(
            keys.data_ptr(), int(keys.dtype == torch.bfloat16), vals.data_ptr(),
            idx.data_ptr(), R, N, M, r, k, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed ({code})")
    return launch, vals, idx


def main(argv=None) -> None:
    dev = torch.device("cuda")
    name_limit = card()
    libs = build_variants(
        "k2a_", {name: {"approx_select.cu": text} for name, text in
                 stage_sources((_build.CSRC / "approx_select.cu").read_text()).items()},
        {"pcaudio_approx_topk": _build.SIGNATURES["pcaudio_approx_topk"]})
    print_ptxas("k2a_", ["whole"])
    for gname, grid in grids(dev).items():
        keys = grid.reshape(grid.shape[0], -1)
        n = keys.shape[0]
        k2 = cuda_ms(lambda: exact_topk_chunks(grid, K), 10)
        b = bound_ms({}, keys.numel() * keys.element_size() + n * K * 8.0)[0]
        for recall in RECALLS:
            launch, v, i = _select(libs["whole"], keys, K, recall)
            launch()
            rv, ri = approx_topk_chunks_plain(keys, K, recall)
            if not (torch.equal(i, ri) and torch.equal(v, rv)):
                raise AssertionError(f"K2a differs from its plain version ({gname}, {recall})")
            t = {s: cuda_ms(_select(libs[s], keys, K, recall)[0], 10) for s in STAGES}
            print(f"[K2a stages] {gname} grid, {n} rows of {keys.shape[1]} bf16, K {K}, "
                  f"recall {recall} {approx_topk_plan(keys.shape[1], K, recall)}: load "
                  f"{t['load']:.4f} ms, window maxima {t['windows'] - t['load']:.4f}, "
                  f"select to tau {t['tau'] - t['windows']:.4f}, compaction "
                  f"{t['compaction'] - t['tau']:.4f}, flat order {t['whole'] - t['compaction']:.4f}, "
                  f"whole {t['whole']:.4f} ms; K2 {k2:.4f} ms; bound {b:.4f} ms by bytes "
                  f"({name_limit})", flush=True)
        del grid, keys
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
