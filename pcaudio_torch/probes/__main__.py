"""``python -m pcaudio_torch.probes <name>|all [--profile]``: run probes on
the card and print, beside every time, the card's name and power limit.
``--profile`` also prints ``torch.profiler``'s device time by kernel over
each probe's run (kernels, plain versions and library calls alike)."""
from __future__ import annotations

import argparse

from pcaudio_torch.probes import PROBES
from pcaudio_torch.probes.timing import card, describe


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m pcaudio_torch.probes")
    ap.add_argument("name", choices=[*PROBES, "all"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    names = list(PROBES) if args.name == "all" else [args.name]
    for name in names:
        probe = PROBES[name]
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                res = probe.run(args.device, args.seed)
        else:
            res = probe.run(args.device, args.seed)
        where = card()
        print(f"[{name}] replaces {probe.replaces}")
        for case, r in res.items():
            print(f"[{name}] {case}: {describe(r)} ({where})")
        for line in probe.summary(res):
            print(f"[{name}] {line} ({where})")
        if args.profile:
            print(f"[{name}] torch.profiler, device time by kernel ({where}):")
            print(prof.key_averages().table(sort_by="self_device_time_total",
                                            row_limit=12, max_name_column_width=60))


if __name__ == "__main__":
    main()
