"""The readers of the program's spans and counters (``pcbench/spans.py``,
the ``program_span`` and ``program_counter`` metrics) on hand-built traces,
and each cell's window at the harness tests' tiny sizes under the CPU
profiler: the program's counters and request spans against the harness's
own counts of the window.

Run: ``python -m pytest pcbench/tests -q``.
"""
import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pcbench import run as R
from pcbench.spans import host_spans
from pcbench.trace import Trace
from pcaudio_torch.utils import profiling
from test_pcbench_harness import BENCH, tiny_run

MS = 1e-3
NEW = {"k1_valid_share.serve", "clouds_ms.serve", "kept_share.sweep", "host_idle_ms.sweep",
       "forward_ms.train", "backward_ms.train", "host_idle_ms.train"}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ctx(kernels=(), notes=(), host=(), **counts):
    return types.SimpleNamespace(trace=Trace(list(kernels), list(notes), list(host)),
                                 counts=counts)


def read(name, c):
    return R.reader(name).read(c)


def test_the_new_metrics_are_listed():
    per = {m["name"]: m for m in BENCH["per_layer"]}
    assert NEW <= set(per)
    for n in NEW:
        assert per[n]["source"] in ("program_span", "program_counter")
        assert per[n]["workloads"]


# ------------------------------------------------------------ hand-built

def _serve_trace():
    """One batch: K3, two kernels under ``pipeline.clouds``, K1, one under
    ``pipeline.mean``, and the logits' copy after the call."""
    k = [("frames", 0.0, 1 * MS), ("log", 1.0 * MS, 1.1 * MS), ("stack", 1.2 * MS, 1.25 * MS),
         ("fused_st", 1.3 * MS, 9.0 * MS), ("mean", 9.0 * MS, 9.02 * MS),
         ("copy", 9.1 * MS, 9.2 * MS)]
    notes = [("pipeline.clouds", 1.0 * MS, 1.25 * MS), ("pipeline.mean", 9.0 * MS, 9.02 * MS)]
    return k, notes


def test_clouds_ms_by_hand():
    k, notes = _serve_trace()
    assert read("clouds_ms.serve", ctx(k, notes, batches=1)) == pytest.approx(0.17)
    assert read("clouds_ms.serve", ctx(k, notes, batches=2)) == pytest.approx(0.085)
    assert read("clouds_ms.serve", ctx(k, [], batches=1)) is None


def _train_trace():
    """Two steps: forward, the backward's kernels (none under a range),
    Adam under ``Optimizer.step#Adam.step``, the accuracy; the second step
    with an idle gap in its backward and one of 1 µs."""
    k, notes, host = [], [], []
    for i, t in enumerate((0.0, 20 * MS)):
        k += [("fwd", t, t + 5 * MS), ("bwd", t + 5 * MS, t + 9 * MS),
              ("bwd", t + 9 * MS + (3 * MS if i else 0), t + 14 * MS),
              ("adam", t + 14 * MS, t + 14.5 * MS),
              ("argmax", t + 14.5 * MS + (0.001 * MS if i else 0), t + 14.6 * MS)]
        notes += [("train.forward", t, t + 5 * MS),
                  ("Optimizer.step#Adam.step", t + 14 * MS, t + 14.5 * MS)]
        host += [("train.step", t - 1 * MS, t + 15 * MS)]
    return k, notes, host


def test_train_spans_by_hand():
    k, notes, host = _train_trace()
    c = ctx(k, notes, host, steps=2)
    assert read("forward_ms.train", c) == pytest.approx(5.0)
    # step 1: 4 + 5 ms; step 2: 4 + 2 ms (its second kernel starts 3 ms late)
    assert read("backward_ms.train", c) == pytest.approx(7.5)
    # the 3 ms gap lies in a train.step span; the 1 µs gap is under the floor
    assert read("host_idle_ms.train", c) == pytest.approx(1.5)
    # the 5.4 ms between the steps lies outside both train.step spans
    host2 = [("train.step", 0.0, 14.65 * MS), ("train.step", 14.65 * MS, 35 * MS)]
    assert read("host_idle_ms.train", ctx(k, notes, host2, steps=2)) == pytest.approx(
        (5.4 + 3.0) / 2)
    assert read("forward_ms.train", ctx(k, [], host, steps=2)) is None
    assert read("backward_ms.train", ctx(k, notes[::2], host, steps=2)) is None
    assert read("host_idle_ms.train", ctx(k, notes, [], steps=2)) is None


def test_sweep_host_idle_by_hand():
    k = [("a", 0.0, 1 * MS), ("b", 3 * MS, 4 * MS), ("c", 10 * MS, 11 * MS)]
    host = [("expt2.call", 0.0, 5 * MS), ("expt2.call", 5.5 * MS, 11 * MS)]
    # the gap 1-3 ms lies in the first call, 4-10 ms (midpoint 7) in the second
    assert read("host_idle_ms.sweep", ctx(k, [], host, calls=2)) == pytest.approx(4.0)
    assert read("host_idle_ms.sweep", ctx(k, [], host[:1], calls=2)) == pytest.approx(1.0)
    assert read("host_idle_ms.sweep", ctx(k, [], [], calls=2)) is None


@pytest.mark.parametrize("name,valid,run,want", [
    ("k1_valid_share.serve", "pipeline.clouds_valid", "pipeline.clouds_st", 50.25),
    ("kept_share.sweep", "expt2.points_kept", "expt2.points_run", 50.25)])
def test_counter_readers_by_hand(name, valid, run, want, monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: {valid: 201, run: 400, "other": 1})
    assert read(name, ctx()) == pytest.approx(want)
    monkeypatch.setattr(profiling, "counters", lambda: {run: 400})
    assert read(name, ctx()) is None
    monkeypatch.delattr(profiling, "counters")  # a program that keeps none
    assert read(name, ctx()) is None


# ------------------------------------------------- the cells on the CPU

REQUEST = {"serve": ("pipeline.classify", "batches"), "sweep": ("expt2.call", "calls"),
           "train": ("train.step", "steps")}
COUNTERS = {"serve": {"pipeline.clouds_st": "clouds", "pipeline.clouds_valid": "valid_clouds"},
            "sweep": {"expt2.points_kept": "kept_points"}, "train": {}}


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_program_counts_equal_the_harness_counts(cell, tmp_path):
    run = tiny_run(cell)
    drv = R.driver_of(run)
    kind = run.workload["driver"]
    state = drv.setup(run)
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        w = drv.window(state, 0.3)
    after = profiling.counters()
    drv.release(state)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = Trace.from_chrome(json.loads(path.read_text()))
    span, unit = REQUEST[kind]
    assert w.counts[unit] >= 1
    assert len(host_spans(trace, (span,))) == w.counts[unit]
    for counter, count in COUNTERS[kind].items():
        assert after[counter] - before.get(counter, 0) == w.counts[count], counter
    if kind == "sweep":
        assert after["expt2.points_run"] - before.get("expt2.points_run", 0) == \
            w.counts["clouds"] * (run.config["featurize"]["n_fft"] // 2 + 1)
