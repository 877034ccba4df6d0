"""Timing probes on the card: the port's counterparts of the TPU probe
scripts behind K1's design questions (``scripts/probe_*.py``).  Each probe
runs at its script's shapes, holds its kernel against the kernel's plain
version, and returns per case the kernel's time, the plain version's, a
library call's where one computes the same function, the least time the
card could take, the launches and the error.

    python -m pcaudio_torch.probes <name> [--device cuda] [--seed 0]

  batched_dot  P1  batched bf16 dot                 probe_batched_dot.py
  int8_matmul  P2  int8 vs bf16 tensor-core GEMMs   probe_int8_matmul.py
  lane_width   P4  64- vs 128-wide products, exps   probe_lane_width.py
  int8_attend  P3  the v6 attend in bf16 and int8   probe_int8_attend.py
  st_launch    P5  K1 bare / weights repacked / full wrapper
                                                    probe_v6_{bare,wjit,pack}.py

Every probe needs an NVIDIA GPU and raises without one.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from pcaudio_torch.probes import (
    batched_dot, int8_attend, int8_matmul, lane_width, st_launch)


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
}

