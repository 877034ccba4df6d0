"""Readings of a cell's control: the plain reference put in the program's
place, one precision step below the configuration's (its
``control_precision``), or, for a train cell, ``--variant half`` (half of
each batch left out, the mean taken over the rest).  The limits of
``correct`` are set between these readings and the program's.  The
benchmark's runs never run it.

    python -m pcbench.control --workload <cell> --seeds <n> [<n> ...] [--variant V]

Prints one JSON line a seed.  On the card at the cell's own sizes;
``tests/test_pcbench_harness.py`` runs it on the CPU at a tiny size.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from pcbench import run as R

    ap = argparse.ArgumentParser(prog="python -m pcbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant")
    args = ap.parse_args(argv)
    bench = R.load_json(R.ROOT / "BENCHMARK.json")
    cell = R.find(bench["workloads"], args.workload, "workload")
    R.cache_env(R.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("pcbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        run = R.load_run(R.ROOT, bench, cell, seed, torch.device("cuda", 0))
        variant = args.variant or run.config["control_precision"]
        got = R.driver_of(run).control(run, variant)
        print(json.dumps({"workload": args.workload, "seed": seed, "variant": variant, **got}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
