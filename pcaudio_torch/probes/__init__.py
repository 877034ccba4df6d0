"""Timing probes on the card: the port's counterparts of the TPU probe
scripts behind K1's and K3's design questions (``scripts/probe_*.py``,
``scripts/profile_featurize_variants.py``).  Each probe runs at its
script's shapes, holds its kernel against the kernel's plain version, and
returns per case the kernel's time, the plain version's, a library call's
where one computes the same function, the least time the card could take,
the launches and the error.

    python -m pcaudio_torch.probes <name> [--device cuda] [--seed 0]

  batched_dot  P1  batched bf16 dot                 probe_batched_dot.py
  int8_matmul  P2  int8 vs bf16 tensor-core GEMMs   probe_int8_matmul.py
  lane_width   P4  64- vs 128-wide products, exps   probe_lane_width.py
  int8_attend  P3  the v6 attend in bf16 and int8   probe_int8_attend.py
  st_launch    P5  K1 bare / weights repacked / full wrapper
                                                    probe_v6_{bare,wjit,pack}.py
  int16_load   P6  int16 waves: convert + x·xᵀ, int16 vs f32 sweep
                                                    probe_int16_load.py
  chunk_relayout
               P7  frame rows → chunk lane blocks   probe_chunk_relayout.py
  featurize_blockc
               P8  K3's DFT on tensor cores, G clips a block
                                                    probe_featurize_blockc.py
  featurize_variants
               P9  the same core, rows shifted by the trim start
                                                    profile_featurize_variants.py

Every probe needs an NVIDIA GPU and raises without one.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from pcaudio_torch.probes import (
    batched_dot, chunk_relayout, featurize_blockc, featurize_variants, int8_attend,
    int8_matmul, int16_load, lane_width, st_launch)


class Probe(NamedTuple):
    run: Callable       # run(device="cuda", seed=0) -> {case: result}
    summary: Callable   # summary(result) -> lines as the script prints them
    replaces: str       # the TPU script(s) and line(s)


PROBES = {
    "batched_dot": Probe(batched_dot.run, batched_dot.summary, batched_dot.REPLACES),
    "int8_matmul": Probe(int8_matmul.run, int8_matmul.summary,
                         "scripts/probe_int8_matmul.py:21,44,85"),
    "lane_width": Probe(lane_width.run, lane_width.summary,
                        "scripts/probe_lane_width.py:28,65"),
    "int8_attend": Probe(int8_attend.run, int8_attend.summary, int8_attend.REPLACES),
    "st_launch": Probe(st_launch.run, st_launch.summary,
                       "scripts/probe_v6_bare.py:61, probe_v6_wjit.py:67, "
                       "probe_v6_pack.py:69"),
    "int16_load": Probe(int16_load.run, int16_load.summary, "scripts/probe_int16_load.py:26,45"),
    "chunk_relayout": Probe(chunk_relayout.run, chunk_relayout.summary,
                            "scripts/probe_chunk_relayout.py:34"),
    "featurize_blockc": Probe(featurize_blockc.run, featurize_blockc.summary,
                              "scripts/probe_featurize_blockc.py:59"),
    "featurize_variants": Probe(featurize_variants.run, featurize_variants.summary,
                                "scripts/profile_featurize_variants.py:66"),
}

