"""Run one cell of the benchmark and print its result line.

    python -m pcbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its mix ``pcbench/workloads/<cell>.json`` (which names
its driver ``pcbench/drivers/<driver>.py``), its configuration's file as
``BENCHMARK.json`` gives it, and each per-layer metric's reader
``pcbench/metrics/<metric>.py``.

A run: set-up (the driver builds the program, the weights and the traffic
on the card from the seed, and warms every shape the cell uses; all of it
is ``setup_s``, the first run in a checkout also building the kernels),
then the window (``--trace 0``: ``--seconds`` of untraced work, giving the
end-to-end metrics; ``--trace 1``: the mix's shorter ``trace_seconds``
untraced, for the host-clock readings, then as long under
``torch.profiler``, giving the per-layer metrics), then the device's peak
memory, the program's state freed, and the comparison with the plain
reference that decides ``correct``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "pcaudio")


def cache_env(root: Path) -> None:
    """Compiler caches at fixed paths inside the checkout."""
    base = root / "build" / "pcbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str):
    """The cell's end-to-end metrics and per-layer metrics, as
    ``BENCHMARK.json`` assigns them."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per


def load_run(root: Path, bench: dict, cell: dict, seed: int, device):
    from pcbench.cell import Run

    conf = find(bench["configs"], cell["config"], "configuration")
    return Run(name=cell["name"], seed=seed, config=load_json(root / conf["file"]),
               workload=load_json(HERE / "workloads" / f"{cell['name']}.json"),
               device=device)


def driver_of(run):
    return importlib.import_module(f"pcbench.drivers.{run.workload['driver']}")


def reader(name: str):
    """The reader of per-layer metric ``name`` (``metrics/<name>.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "pcbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_loaded():
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(BANNED))


class Context:
    """What a per-layer reader is given: the trace, the traced window's
    ``counts`` and ``window_s`` and the device's ``busy_s`` in it, the
    run's ``config`` and ``workload``, and ``host``, an untraced window of
    the same length just before it, from which host-clock readings come
    (the profiler slows the host)."""

    def __init__(self, trace, window, host, run):
        self.trace, self.host = trace, host
        self.busy_s = trace.busy_s()
        self.window_s = window.seconds
        self.counts = window.counts
        self.config, self.workload = run.config, run.workload


def execute(run, bench: dict, seconds: float, trace: bool, t_start: float):
    """Set-up, window, peak memory, release, comparison.  Returns ``(result
    line without its device entry, checks, peak bytes, the traced run's
    busy and window seconds)``; ``checks`` are ``(name, value, limit)``,
    correct where every value is at most its limit."""
    import torch

    from pcbench import trace as tr
    from pcbench.cell import sync

    e2e, per = cell_metrics(bench, run.name)
    drv = driver_of(run)
    state = drv.setup(run)
    sync(run.device)
    setup_s = time.perf_counter() - t_start
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    if trace:
        host = drv.window(state, min(seconds, run.workload["trace_seconds"]))
        with tr.traced() as box:
            w = drv.window(state, min(seconds, run.workload["trace_seconds"]))
    else:
        w = drv.window(state, seconds)
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    drv.release(state)
    checks = drv.check(state)
    metrics, extra = {}, {}
    if trace:
        ctx = Context(box[0], w, host, run)
        for m in per:
            v = reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": ctx.busy_s, "window_s": ctx.window_s}
    else:
        for m in e2e:
            v = setup_s if m["name"] == "setup_s" else w.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    failed = w.failed + (host.failed if trace else 0)
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)
    line = {"correct": correct, "attempted": w.attempted + (host.attempted if trace else 0),
            "failed": failed,
            "metrics": metrics}
    if trace:
        line["breakdown"] = tr.breakdown(box[0])
    return line, checks, peak, extra


def card() -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        out["power_limit"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = "unknown"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pcbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find(bench["workloads"], args.workload, "workload")
    cache_env(ROOT)
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"pcbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = load_run(ROOT, bench, cell, args.seed, torch.device("cuda", 0))
    torch.cuda.init()
    run.marks[:0] = [("import torch", t_torch), ("CUDA context", time.perf_counter())]
    line, checks, peak, extra = execute(run, bench, args.seconds, bool(args.trace), T_START)
    bad = banned_loaded()
    if bad:
        print(f"pcbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    line["device"] = {**card(), "count": cell["chips"], "memory_peak_bytes": peak, **extra}
    if "breakdown" in line:
        line["breakdown"] = line.pop("breakdown")
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    t = T_START
    phases = []
    for name, at in run.marks:
        phases.append(f"{name} {at - t:.3f} s")
        t = at
    print("set-up: " + ", ".join(phases), file=sys.stderr)
    for n, v, lim in checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
