"""The harness on the CPU: ``BENCHMARK.json`` against the files it names,
the contract's shapes, a cell added by files alone, the import ban, the
plain reference against hand-built cases, each cell driven end to end at a
tiny size (sound, and with the timed path broken underneath), and each
control reading above its limit.  Card-only smoke runs of every cell carry
the ``cuda`` marker and skip without a card.

Run: ``python -m pytest pcbench/tests -q`` (about a minute); on the card
``python -m pytest pcbench/tests -q -m cuda``.
"""
import ast
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pcbench import run as R

PCBENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = PCBENCH.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BANNED = {"jax", "jaxlib", "flax", "pcaudio"}

# each cell cut to a size the CPU runs in seconds (the drivers, the
# reference and the comparison unchanged)
TINY = {
    "serve": {"clips": 16, "buffer_samples": 44100, "pool": 2, "warm_batches": 1},
    "sweep": {"clips": 2, "buffer_samples": 13312, "clip_seconds": [0.3, 0.3], "pool": 2,
              "nruns": 2, "list_K": [1, 51, 1024]},
    "train": {"batch": 16, "pool": 4, "clips": 2, "buffer_samples": 44100,
              "clip_seconds": [1.0, 1.0]},
}


def tiny_run(cell_name: str, seed: int = 2 ** 33 + 5):
    cell = R.find(BENCH["workloads"], cell_name, "workload")
    run = R.load_run(ROOT, BENCH, cell, seed, torch.device("cpu"))
    kind = run.workload["driver"]
    run.workload.update(TINY[kind])
    if kind == "serve":
        lo, hi = run.workload["clip_seconds"]
        run.workload["clip_seconds"] = [min(lo, 1.0), 1.0]
    return run


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the file

def test_every_cell_finds_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        conf = configs[cell["config"]]
        assert (ROOT / conf["file"]).is_file()
        wl = json.loads((PCBENCH / "workloads" / f"{cell['name']}.json").read_text())
        assert (PCBENCH / "drivers" / f"{wl['driver']}.py").is_file()
        for k in ("setup", "window", "release", "check", "control"):
            assert callable(getattr(R.driver_of(R.load_run(ROOT, BENCH, cell, 1, "cpu")), k))
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == set(configs)


def test_every_metric_has_a_reader_and_one_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert callable(R.reader(m["name"]).read), m["name"]
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            reported = [n for n, e in e2e.items() if cell in e.get("workloads", cells)]
            assert m["moves"] in reported, (m["name"], cell)
    for cell in cells:
        e, per = R.cell_metrics(BENCH, cell)
        names = {x["name"] for x in e}
        assert "setup_s" in names and len(names) >= 2 and per, cell


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("pcbench/")
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A new mix, configuration and per-layer metric, added as files and
    entries of ``BENCHMARK.json`` in a copy, run with no other edit."""
    shutil.copytree(PCBENCH, tmp_path / "pcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    wl = json.loads((PCBENCH / "workloads" / "3st.serve.clips5s.json").read_text())
    wl.update(TINY["serve"], clip_seconds=[1.0, 1.0], why="a throwaway cell")
    (tmp_path / "pcbench" / "workloads" / "3st.serve.tiny.json").write_text(json.dumps(wl))
    conf = json.loads((PCBENCH / "configs" / "3st-esc10.json").read_text())
    conf["name"] = "3st-tiny"
    (tmp_path / "pcbench" / "configs" / "3st-tiny.json").write_text(json.dumps(conf))
    (tmp_path / "pcbench" / "metrics" / "batches.tiny.py").write_text(
        "def read(ctx):\n    return float(ctx.counts['batches'])\n")
    bench["configs"].append({"name": "3st-tiny", "source": "https://arxiv.org/abs/2105.02469",
                             "file": "pcbench/configs/3st-tiny.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "3st.serve.tiny", "config": "3st-tiny",
                               "traffic": "serve.tiny", "chips": 1, "why": "x"})
    bench["end_to_end"][1]["workloads"].append("3st.serve.tiny")
    bench["per_layer"].append({"name": "batches.tiny", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "serve_clips_per_s", "workloads": ["3st.serve.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, torch\n"
        "from pcbench import run as R\n"
        "b = R.load_json(R.ROOT / 'BENCHMARK.json')\n"
        "cell = R.find(b['workloads'], '3st.serve.tiny', 'w')\n"
        "run = R.load_run(R.ROOT, b, cell, 7, torch.device('cpu'))\n"
        "line, checks, _, _ = R.execute(run, b, 0.5, False, 0.0)\n"
        "e, per = R.cell_metrics(b, '3st.serve.tiny')\n"
        "print(json.dumps([line['correct'], sorted(line['metrics']), [m['name'] for m in per]]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    correct, metrics, per = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and metrics == ["serve_clips_per_s", "setup_s"]
    assert "batches.tiny" in per


# ------------------------------------------------------------ the import ban

def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in PCBENCH.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in BANNED, (path, mod)
    for path in (PCBENCH / "reference").rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] != "pcaudio_torch", (path, mod)
            assert mod.split(".")[0] in {"pcbench", "torch", "numpy", "math", "typing",
                                         "__future__"}, (path, mod)


def test_importing_the_harness_loads_no_banned_module():
    code = ("import importlib, pkgutil, sys, pcbench\n"
            "for m in pkgutil.walk_packages(pcbench.__path__, 'pcbench.'):\n"
            "    if '.tests' not in m.name and not m.name.endswith('__main__'):\n"
            "        importlib.import_module(m.name)\n"
            "import pcaudio_torch.eval.pipeline, pcaudio_torch.eval.experiments\n"
            "import pcaudio_torch.train.step\n"
            "print(sorted({k.split('.')[0] for k in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not loaded & BANNED


def test_top_level_names_compared_whole():
    assert "pcaudio_torch".split(".")[0] not in BANNED
    sys.modules.setdefault("pcaudio_torch_probe_name", object())
    try:
        assert "pcaudio_torch_probe_name" not in R.banned_loaded()
    finally:
        del sys.modules["pcaudio_torch_probe_name"]


# --------------------------------------------------- the reference by hand

def test_trim_keeps_the_loud_middle():
    from pcbench.reference.featurize import trim_bounds

    L = 40 * 512
    x = torch.zeros(2, L)
    t = torch.arange(L) / 44100.0
    x[0, 10 * 512: 20 * 512] = 0.5 * torch.sin(2 * math.pi * 440 * t[10 * 512: 20 * 512])
    x[1] = 0.5 * torch.sin(2 * math.pi * 440 * t)
    start, tlen = trim_bounds(x, torch.tensor([L, 30 * 512]))
    # frames of 2,048 samples centered on t·512: frame 9 is the first to
    # reach the tone, frame 21 the last
    assert start.tolist() == [9 * 512, 0]
    assert tlen.tolist() == [(22 - 9) * 512, 30 * 512]
    s, n = trim_bounds(torch.zeros(1, L), torch.tensor([L]))  # silence: untrimmed
    assert (s.item(), n.item()) == (0, L)


def test_top_k_ties_in_flat_order():
    from pcbench.reference.featurize import serve_clouds

    # a silent chunk: every bin ties at 0 (and -0.0 with it), so the top K
    # are the first K flat indices
    pipe = {"fs": 44100, "n_fft": 1024, "num_frames": 10, "top_k": 5, "top_db": 60.0}
    waves = torch.zeros(1, 10 * 512)
    pts, valid = serve_clouds(waves, torch.tensor([10 * 512]), pipe)
    cf = float(torch.tensor(0.5 / 511, dtype=torch.bfloat16))
    assert torch.equal(pts[0, :, 0].float(), torch.arange(5, dtype=torch.bfloat16).float() * cf)
    assert bool(valid.all())
    vals = torch.tensor([[0.0, -0.0, 3.0, -0.0, 3.0, 1.0]])
    order = torch.sort(vals, descending=True, stable=True).indices[0, :4].tolist()
    assert order == [2, 4, 5, 0]


def test_masked_st_ignores_masked_points():
    from pcbench.reference.st import st_forward
    from pcbench.weights import st_state_dict

    cfg = {"dim_input": 2, "dim_hidden": 16, "num_inds": 4, "num_classes": 3}
    p = st_state_dict(3, cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 7, 2, generator=g)
    junk = torch.cat([x, 100 * torch.randn(2, 5, 2, generator=g)], 1)
    mask = torch.arange(12)[None, :].expand(2, 12) < 7
    a = st_forward(p, x, None, heads=4)
    b = st_forward(p, junk, mask, heads=4)
    assert torch.allclose(a, b, atol=1e-5, rtol=1e-5)


def test_the_port_loads_the_harness_weights():
    from pcbench.program import build_st
    from pcbench.reference.st import st_forward
    from pcbench.weights import st_state_dict

    run = tiny_run("fst.train.b1024")
    p = st_state_dict(11, run.config["model"], "cpu")
    model = build_st(run, p)
    x = torch.randn(3, 40, 2)
    with torch.no_grad():
        assert torch.allclose(model(x), st_forward(p, x, None, 8), atol=1e-5)


# ---------------------------------------------- whole runs at a tiny size

def _execute(run):
    line, checks, _, _ = R.execute(run, BENCH, 0.3, False, 0.0)
    return line, {n: (v, lim) for n, v, lim in checks}


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_sound_run_is_correct(cell):
    line, checks = _execute(tiny_run(cell))
    assert line["correct"], checks
    assert line["attempted"] >= 1 and line["failed"] == 0


def _alter_one_answer(monkeypatch):
    from pcaudio_torch.eval import pipeline

    make = pipeline.make_temporal_classifier

    def broken(*a, **k):
        fn = make(*a, **k)

        def g(waves, lengths):
            out = fn(waves, lengths).clone()
            out[0, 0] += 0.5
            return out
        return g
    monkeypatch.setattr(pipeline, "make_temporal_classifier", broken)


def _serve_half_the_chunks(monkeypatch):
    from pcaudio_torch.eval import pipeline

    chunk_logits = pipeline._chunk_logits

    def broken(*a, **k):
        logits, mask = chunk_logits(*a, **k)
        mask = mask.clone()
        mask[:, mask.shape[1] // 2:] = False
        return logits, mask
    monkeypatch.setattr(pipeline, "_chunk_logits", broken)


def _serve_half_the_batch(monkeypatch):
    from pcaudio_torch.eval import pipeline

    make = pipeline.make_temporal_classifier

    def broken(*a, **k):
        fn = make(*a, **k)

        def g(waves, lengths):
            h = waves.shape[0] // 2
            out = fn(waves[:h], lengths[:h])
            return torch.cat([out, out.mean(0, keepdim=True).expand(waves.shape[0] - h, -1)])
        return g
    monkeypatch.setattr(pipeline, "make_temporal_classifier", broken)


def _sweep_alter_one_answer(monkeypatch):
    from pcaudio_torch.eval import experiments

    make = experiments.make_cloud_classifier

    def broken(model):
        fn = make(model)

        def g(points, mask=None):
            out = fn(points, mask).clone()
            out[0, :] = out[0, :].flip(0)
            return out
        return g
    monkeypatch.setattr(experiments, "make_cloud_classifier", broken)


def _sweep_half_the_batch(monkeypatch):
    from pcaudio_torch.eval import experiments

    hits = experiments._hits

    def broken(logits, labels, valid=None):
        h = max(logits.shape[0] // 2, 1)
        return hits(logits[:h], labels[:h], None if valid is None else valid[:h]) * 2
    monkeypatch.setattr(experiments, "_hits", broken)


def _train_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _train_half_the_batch(monkeypatch):
    from pcaudio_torch.train import step as step_mod

    make = step_mod.make_train_step

    def broken(apply_fn, opt, **k):
        inner = make(apply_fn, opt, **k)
        return lambda batch: inner({n: v[: v.shape[0] // 2] for n, v in batch.items()})
    monkeypatch.setattr(step_mod, "make_train_step", broken)


FAULTS = [
    ("3st.serve.clips5s", _alter_one_answer), ("3st.serve.clips5s", _serve_half_the_batch),
    ("3st.serve.ragged", _alter_one_answer), ("3st.serve.ragged", _serve_half_the_chunks),
    ("fst.sweep.expt2", _sweep_alter_one_answer), ("fst.sweep.expt2", _sweep_half_the_batch),
    ("fst.train.b1024", _train_state_unchanged), ("fst.train.b1024", _train_half_the_batch),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line, checks = _execute(tiny_run(cell))
    assert not line["correct"], checks


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_control_is_not_correct(cell):
    """The reference one precision step below the configuration's, in the
    program's place, fails one of the cell's limits."""
    run = tiny_run(cell)
    got = R.driver_of(run).control(run, run.config["control_precision"])
    assert any(v > run.limits[k] for k, v in got.items()), (got, run.limits)


# ---------------------------------------------------------- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_runs_on_the_card(cell):
    _card()
    for trace in (0, 1):
        out = subprocess.run([sys.executable, "-m", "pcbench", "--workload", cell, "--seed",
                              str(2 ** 31 + 99), "--seconds", "2", "--trace", str(trace)],
                             cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"], line["checks"]
        assert line["device"]["platform"] == "gpu" and line["metrics"]
        for name, m in line["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < m["value"] <= 100, (name, m)
        assert np.isfinite([m["value"] for m in line["metrics"].values()]).all()
