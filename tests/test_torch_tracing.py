"""The port's spans and counters (``pcaudio_torch/utils/profiling.py``) on
the CPU: off without a profiler (no ``record_function`` entered, no counter
moved); under ``torch.profiler`` the serving pipelines' (3ST, AST), the expt-2
sweep's and the train step's spans in the exported Chrome trace, nested as
the paths nest them, and their counters equal to what the paths handled."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pcaudio_torch.eval import experiments as ex
from pcaudio_torch.eval.pipeline import (
    SpectrogramPipelineConfig, TemporalPipelineConfig, extract_chunk_clouds,
    make_spectrogram_classifier, make_temporal_classifier)
from pcaudio_torch.nn import AST, ST
from pcaudio_torch.train.glue import pointcloud_apply
from pcaudio_torch.train.step import make_train_step
from pcaudio_torch.utils import profiling

FS = 44100
PREFIXES = ("pipeline.", "expt2.", "train.")

# each span's innermost enclosing program span (None: a request's top)
SERVE_PARENTS = {"pipeline.classify": {None}, "pipeline.featurize": {"pipeline.classify"},
                 "pipeline.select": {"pipeline.classify"},
                 "pipeline.clouds": {"pipeline.classify"},
                 "pipeline.st": {"pipeline.classify"}, "pipeline.mean": {"pipeline.classify"}}
AST_PARENTS = {"pipeline.classify": {None}, "pipeline.fbank": {"pipeline.classify"},
               "pipeline.embed": {"pipeline.classify"},
               "pipeline.encoder": {"pipeline.classify"},
               "pipeline.attn": {"pipeline.encoder"}, "pipeline.head": {"pipeline.classify"}}
SWEEP_PARENTS = {"expt2.call": {None}, "expt2.featurize": {"expt2.call", "expt2.microbatch"},
                 "expt2.microbatch": {"expt2.call"}, "expt2.ranks": {"expt2.microbatch"},
                 "expt2.forward": {"expt2.microbatch"}, "expt2.results": {"expt2.call"}}
TRAIN_PARENTS = {"train.step": {None}, "train.forward": {"train.step"},
                 "train.backward": {"train.step"}, "train.optimizer": {"train.step"}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: pytest-xdist runs several workers side by
    side, and their default thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clips(L=65536, lengths=(60000, 42000), seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array(lengths, np.int32)
    w = np.zeros((len(lengths), L), np.float32)
    t = np.arange(L) / FS
    for i, n in enumerate(lengths):
        w[i, :n] = 0.3 * np.sin(2 * np.pi * 440.0 * (i + 1) * t[:n]) \
            + 0.05 * rng.standard_normal(n)
    return torch.from_numpy(w), torch.from_numpy(lengths)


def _st(din, dim=8, inds=4, heads=2):
    torch.manual_seed(0)
    return ST(dim_input=din, dim_output=10, num_inds=inds, dim_hidden=dim,
              num_heads=heads)


def _run(fn, tmp_path):
    """``fn()`` under the CPU profiler: its result, the program's spans in
    the exported trace ``[(name, start, end)]`` by start, and each
    counter's change."""
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling._recording()
        out = fn()
    assert not profiling._recording()
    after = profiling.counters()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation" and e.get("ph") == "X"
                    and e["name"].startswith(PREFIXES)), key=lambda s: (s[1], -s[2]))
    return out, spans, {k: v - before.get(k, 0) for k, v in after.items()}


def _parents(spans, eps=0.01):
    """``[(name, the innermost enclosing span's name or None)]``."""
    out = []
    for i, (n, s, e) in enumerate(spans):
        inner = None
        for j, (m, a, b) in enumerate(spans):
            if j != i and a <= s + eps and e <= b + eps and (b - a) >= (e - s):
                if inner is None or b - a < inner[2] - inner[1]:
                    inner = (m, a, b)
        out.append((n, inner[0] if inner else None))
    return out


def _check_nesting(spans, parents):
    got = _parents(spans)
    assert {n for n, _ in got} == set(parents)
    for n, p in got:
        assert p in parents[n], (n, p)


def test_off_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    waves, lengths = _clips()
    model = _st(3).eval()
    cfg = TemporalPipelineConfig(top_k=16)
    before = profiling.counters()
    make_temporal_classifier(model, cfg, plain=True)(waves, lengths)
    fst = _st(2).eval()
    ex.framewise_expt2(None, ex.make_cloud_classifier(fst), waves[:, :8000],
                       torch.tensor([8000, 6000]), torch.tensor([1, 2]), mode="cloud",
                       Nfft=256, list_K=[1, 129], nruns=1, device="cpu")
    step = make_train_step(pointcloud_apply(fst), torch.optim.Adam(fst.parameters()))
    step({"points": torch.randn(4, 9, 2), "labels": torch.tensor([0, 1, 2, 3])})
    assert profiling.counters() == before
    assert profiling.span("x") is profiling.span("y")
    profiling.count("test.off", 3)
    profiling.count_device("test.off_device", torch.ones(3))
    assert profiling.counters() == before


def test_gate_follows_the_profiler():
    assert not profiling._recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling._recording()
        assert isinstance(profiling.span("x"), torch.profiler.record_function)
    assert not profiling._recording()


def test_counters_count_inside_a_profile(tmp_path):
    def work():
        profiling.count("test.host", 3)
        profiling.count("test.host", 4)
        profiling.count_device("test.device", torch.tensor([True, False, True]))
        profiling.count_device("test.device", torch.tensor([2, 5]))

    _, _, delta = _run(work, tmp_path)
    assert delta["test.host"] == 7 and delta["test.device"] == 9


def test_serving_spans_and_counters(tmp_path):
    waves, lengths = _clips()
    model = _st(3).eval()
    cfg = TemporalPipelineConfig(top_k=16)
    fn = make_temporal_classifier(model, cfg, plain=True)
    _, chunk_mask = extract_chunk_clouds(waves, lengths, cfg, plain=True)
    out, spans, delta = _run(lambda: fn(waves, lengths), tmp_path)
    assert out.shape == (2, 10)
    _check_nesting(spans, SERVE_PARENTS)
    assert [n for n, _, _ in spans].count("pipeline.classify") == 1
    B, C = chunk_mask.shape
    assert delta["pipeline.clouds_st"] == B * C
    assert delta["pipeline.clouds_valid"] == int(chunk_mask.sum())
    assert 0 < int(chunk_mask.sum()) < B * C  # the shorter clip leaves chunks invalid


def test_spectrogram_spans_and_counters(tmp_path):
    torch.manual_seed(0)
    model = AST(num_mel_bins=32, max_length=64, dim=128, depth=2, heads=2, mlp=256,
                num_labels=10).eval()
    fn = make_spectrogram_classifier(model, SpectrogramPipelineConfig(num_mel_bins=32,
                                                                      max_length=64))
    # 9,000 samples make 54 frames; 5,000 make 29
    waves, lengths = torch.randn(2, 9000) * 0.1, torch.tensor([9000, 5000])
    out, spans, delta = _run(lambda: fn(waves, lengths), tmp_path)
    assert out.shape == (2, 10) and out.dtype == torch.float32
    _check_nesting(spans, AST_PARENTS)
    names = [n for n, _, _ in spans]
    assert names.count("pipeline.classify") == 1 and names.count("pipeline.attn") == 2
    assert delta["pipeline.tokens"] == 2 * model.num_tokens == 2 * (2 * 5 + 2)
    assert delta["pipeline.frames_valid"] == 54 + 29


def test_sweep_spans_and_counters(tmp_path):
    waves, lengths = _clips(L=20000, lengths=(20000, 14000))
    model = _st(2).eval()
    shapes = []
    clf = ex.make_cloud_classifier(model)

    def recording(points, mask=None):
        shapes.append(tuple(points.shape))
        return clf(points, mask)

    list_K, R = [1, 64, 129], 2
    _, spans, delta = _run(lambda: ex.framewise_expt2(
        None, recording, waves, lengths, torch.tensor([3, 7]), mode="cloud", Nfft=256,
        list_K=list_K, nruns=R, device="cpu"), tmp_path)
    _check_nesting(spans, SWEEP_PARENTS)
    names = [n for n, _, _ in spans]
    assert names.count("expt2.call") == 1
    assert names.count("expt2.forward") == len(shapes) == len(list_K) * (R + 1)
    n = 256 // 2 + 1  # the frame cloud's points
    rows = shapes[0][0]
    # each forward runs its mask's kept points alone: [rows, min(K, n), 2]
    assert shapes == [(rows, min(list_K[i // (R + 1)], n), 2) for i in range(len(shapes))]
    kept = sum(r * min(list_K[(i // (R + 1)) % len(list_K)], n)
               for i, (r, _, _) in enumerate(shapes))
    assert delta["expt2.points_kept"] == kept
    assert delta["expt2.points_run"] == sum(r * pts for r, pts, _ in shapes)
    assert delta["expt2.points_run"] == delta["expt2.points_kept"]


def test_train_step_spans(tmp_path):
    model = _st(2)
    step = make_train_step(pointcloud_apply(model), torch.optim.Adam(model.parameters()))
    batch = {"points": torch.randn(6, 11, 2), "labels": torch.arange(6)}
    out, spans, _ = _run(lambda: step(batch), tmp_path)
    assert set(out) == {"loss", "accuracy"}
    _check_nesting(spans, TRAIN_PARENTS)
    assert [n for n, _, _ in spans].count("train.step") == 1
