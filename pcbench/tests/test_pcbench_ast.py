"""The AST cell and the full-grid 3ST cell on the CPU at a tiny size: the
windowed-sinc resampler, the seeded weights against the port's ``AST``,
the FLOP count at the published sizes, each cell driven end to end (sound,
and with the timed path broken underneath), and each control reading above
its limit.

Run: ``python -m pytest pcbench/tests/test_pcbench_ast.py -q``.
"""
import json
import math
import pathlib

import pytest
import torch

from pcbench import ast_roofline as ar
from pcbench import run as R
from pcbench.reference import ast as ra

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL = {"hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 2,
         "intermediate_size": 256, "num_mel_bins": 32, "max_length": 64}
# the tiny AST's bf16 program against the bf16-operand reference reads about
# 0.1 (tests/test_torch_ast.py), so the tiny runs take that file's 0.25
TINY_LIMIT = 0.25


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_run(cell_name, seed=2 ** 33 + 7):
    cell = R.find(BENCH["workloads"], cell_name, "workload")
    run = R.load_run(ROOT, BENCH, cell, seed, torch.device("cpu"))
    if run.workload["driver"] == "serve_ast":
        run.config["model"].update(SMALL)
        run.config["pipeline"].update(num_mel_bins=32, max_length=64)
        run.workload.update(clips=4, source_samples=35280, buffer_samples=12800,
                            clip_seconds=[0.8, 0.8], pool=2, warm_batches=1,
                            limits={"logit_gap": TINY_LIMIT})
    else:
        run.workload.update(clips=4, buffer_samples=44100, clip_seconds=[1.0, 1.0],
                            pool=2, warm_batches=1)
    return run


def test_resample_keeps_a_tone():
    t44 = torch.arange(44100) / 44100.0
    x = torch.sin(2 * math.pi * 1000.0 * t44)[None]
    y = ra.resample(x, 44100, 16000)
    assert y.shape == (1, 16000)
    t16 = torch.arange(16000) / 16000.0
    want = torch.sin(2 * math.pi * 1000.0 * t16)
    assert float((y[0, 400:-400] - want[400:-400]).abs().max()) < 2e-3
    # above the new Nyquist frequency the Hann window's stop band (about
    # -50 dB here) lets through under 1 %
    z = ra.resample(torch.sin(2 * math.pi * 12000.0 * t44)[None], 44100, 16000)
    assert float(z[0, 400:-400].abs().max()) < 1e-2


def test_flops_at_the_published_sizes():
    m = json.loads((ROOT / "pcbench/configs/ast-audioset-10-10.json").read_text())["model"]
    assert ar.tokens(m) == 1214
    assert abs(ar.ast_flops(m, 1214) / 1e9 - 261.1) < 0.1
    assert abs(ar.k5_flops(m, 1214) / 12 / 1e9 - 4.53) < 0.01


def test_the_port_loads_the_harness_weights():
    from pcaudio_torch.nn import AST

    cfg = dict(json.loads((ROOT / "pcbench/configs/ast-audioset-10-10.json").read_text())
               ["model"], **SMALL)
    p = ra.state_dict(5, cfg, "cpu")
    model = AST(num_mel_bins=32, max_length=64, dim=128, depth=2, heads=2, mlp=256)
    model.load_state_dict(p)
    feats = torch.randn(2, 64, 32)
    with torch.no_grad():
        got = model(feats)
    want = ra.ast_forward(p, feats, cfg)
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())
    assert abs(float(p["blocks.0.fc1.weight"].std()) - 0.02) < 1e-3
    assert float(p["blocks.1.ln2.weight"].min()) == 1.0


def _execute(run):
    line, checks, _, _ = R.execute(run, BENCH, 0.3, False, 0.0)
    return line, {n: (v, lim) for n, v, lim in checks}


@pytest.mark.parametrize("cell", ["ast.serve.clips10s", "3st.serve.fullgrid"])
def test_sound_run_is_correct(cell):
    line, checks = _execute(tiny_run(cell))
    assert line["correct"], checks
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "serve_clips_per_s"}


def _alter_one_answer(monkeypatch):
    from pcaudio_torch.eval import pipeline

    for name in ("make_spectrogram_classifier", "make_temporal_classifier"):
        make = getattr(pipeline, name)

        def broken(*a, _make=make, **k):
            fn = _make(*a, **k)

            def g(waves, lengths):
                out = fn(waves, lengths).clone()
                out[0, 0] += 0.5
                return out
            return g
        monkeypatch.setattr(pipeline, name, broken)


@pytest.mark.parametrize("cell", ["ast.serve.clips10s", "3st.serve.fullgrid"])
def test_broken_path_is_not_correct(cell, monkeypatch):
    _alter_one_answer(monkeypatch)
    line, checks = _execute(tiny_run(cell))
    assert not line["correct"], checks


def test_full_grid_runs_every_bin(monkeypatch):
    from pcaudio_torch.eval import pipeline

    seen = []
    make = pipeline.make_temporal_classifier

    def spy(model, cfg, **k):
        seen.append(cfg.top_k)
        return make(model, cfg, **k)
    monkeypatch.setattr(pipeline, "make_temporal_classifier", spy)
    run = tiny_run("3st.serve.fullgrid")
    _execute(run)
    assert seen == [None] and run.config["pipeline"]["top_k"] is None


@pytest.mark.parametrize("cell", ["ast.serve.clips10s", "3st.serve.fullgrid"])
def test_control_is_not_correct(cell):
    run = tiny_run(cell)
    got = R.driver_of(run).control(run, run.config["control_precision"])
    assert any(v > run.limits[k] for k, v in got.items()), (got, run.limits)


def test_full_grid_k1_roofline_counts_every_bin():
    from types import SimpleNamespace

    from pcbench import roofline as rf

    run = tiny_run("3st.serve.fullgrid")
    serve_fullgrid = R.driver_of(run)
    serve_fullgrid._full_grid(run)
    m = run.config["model"]
    trace = SimpleNamespace(kernels=[("fused_st_scratch_kernel", 0.0, 2e-3),
                                     ("fused_chunk_mag2_kernel", 2e-3, 3e-3)])
    ctx = SimpleNamespace(trace=trace, config=run.config, counts={"valid_clouds": 100})
    got = R.reader("k1_roofline.fullgrid").read(ctx)
    flops = 100 * rf.st_flops(5120, m["dim_input"], m["dim_hidden"], m["num_inds"],
                              m["num_classes"])
    assert got == pytest.approx(100 * flops / rf.PEAK_FLOPS["bf16"] / 2e-3)
    assert R.reader("k1_roofline.fullgrid").read(
        SimpleNamespace(trace=SimpleNamespace(kernels=[]), config=run.config,
                        counts={"valid_clouds": 100})) is None
