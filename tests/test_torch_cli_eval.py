"""``python -m pcaudio_torch.cli eval`` on the CPU: the files it writes have
the keys and lists of the committed JAX sweep results
(``artifacts/roundtrip/FST_*.json``) at the config's own lengths, and for
FB and CNNTemp and the rebuttal sweep those of
``artifacts/cli_cycle/paper_plots/``; ``PCAUDIO_FUSED_ATTN`` keeps its
meaning; and a fused-attention gate that fails exits non-zero instead of
falling back."""
import json
import os

import pytest
import torch

from pcaudio_torch import cli
from pcaudio_torch.checkpoint import export_reference_pth, save_checkpoint
from pcaudio_torch.core.config import (
    ARCH_3ST, ARCH_CNN, ARCH_FB, ARCH_FST, ExperimentConfig)
from pcaudio_torch.data import generate_esc_corpus
from pcaudio_torch.data.esc import ESC10_CATEGORIES
from pcaudio_torch.eval.experiments import default_list_K, default_list_N
from pcaudio_torch.train import RECIPES, TrainState

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "artifacts", "roundtrip")
PAPER_PLOTS = os.path.join(os.path.dirname(__file__), "..", "artifacts", "cli_cycle",
                           "paper_plots")
NFFT = {ARCH_FST: 256, ARCH_3ST: 128}  # FST: list_K 1, 51, 128; 3ST: 13 K


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small CPU ops: one intra-op thread each, or workers
    running side by side (pytest-xdist) oversubscribe the cores and the
    ops' thread handoffs take most of the time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three classes of the synthetic corpus, two 0.15 s clips each: one
    test clip a class."""
    root = tmp_path_factory.mktemp("corpus")
    return generate_esc_corpus(str(root), clips_per_class=2,
                               categories=ESC10_CATEGORIES[:3], clip_seconds=0.15)


def _config(tmp_path, arch):
    cfg = ExperimentConfig(architecture=arch, window_size=NFFT[arch], dhidden=8,
                           nheads=2, ninds=4,
                           Ntemp=10 if arch == ARCH_3ST else None)
    path = os.path.join(tmp_path, "config.json")
    with open(path, "w") as f:
        json.dump(cfg.to_reference_json(), f)
    return cfg, path


def _weights(tmp_path, cfg):
    torch.manual_seed(0)
    path = os.path.join(tmp_path, "net.pth")
    export_reference_pth(cfg.build_model(), path, cfg)
    return path


def _eval(corpus, config, *extra):
    csv, audio = corpus
    return cli.main(["eval", "--config", config, "--esc-csv", csv,
                     "--esc-audio", audio, "--device", "cpu", *extra])


def _read(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", [ARCH_FST, ARCH_3ST], ids=["FST", "3ST"])
def test_writes_the_reference_files(tmp_path, corpus, arch, monkeypatch):
    monkeypatch.delenv("PCAUDIO_FUSED_ATTN", raising=False)
    cfg, config = _config(tmp_path, arch)
    out = os.path.join(tmp_path, "out")
    results, prov = _eval(corpus, config, "--pth", _weights(tmp_path, cfg),
                          "--out-dir", out)
    tag = "FST" if arch == ARCH_FST else "3ST"
    names = [f"{tag}_expt1.json", f"{tag}_randK_expt2.json", f"{tag}_maxK_expt2.json"]
    assert sorted(results) == sorted(names)
    ref1 = _read(os.path.join(ARTIFACTS, "FST_expt1.json"))
    e1 = _read(os.path.join(out, names[0]))
    assert list(e1) == list(ref1) == ["data", "list_Fs", "list_N"]
    assert e1["list_Fs"] == ref1["list_Fs"] == [44100, 32000, 22050.0, 11025.0]
    assert list(e1["data"]) == list(ref1["data"])  # "22050.0", as the reference
    assert e1["list_N"] == default_list_N(NFFT[arch])
    assert len(e1["list_N"]) == len(ref1["list_N"]) == 13
    assert all(len(v) == 13 and all(0.0 <= a <= 1.0 for a in v)
               for v in e1["data"].values())
    n_points = NFFT[arch] // 2 if arch == ARCH_FST else NFFT[arch] * 10 // 2
    for name, ref_name in zip(names[1:], ["FST_randK_expt2.json", "FST_maxK_expt2.json"]):
        got, ref = _read(os.path.join(out, name)), _read(os.path.join(ARTIFACTS, ref_name))
        assert list(got) == list(ref) == ["data", "list_K"]
        assert got["list_K"] == default_list_K(n_points)
        assert ref["list_K"] == default_list_K(1024)
        assert list(got["data"]) == [str(k) for k in got["list_K"]]
        assert all(len(v) == 2 for v in got["data"].values())
        if "maxK" in name:
            assert all(v[1] == 0 for v in got["data"].values())
        side = _read(os.path.join(out, name.replace(".json", ".provenance.json")))
        assert side["engine"] == "plain" and side["backend"] == "cpu"
        assert side["wall_s"] > 0 and side["checkpoint"].endswith("net.pth")
    assert prov["engine"] == "plain" and "fused_gate" not in prov


@pytest.mark.parametrize("what", ["FB", "CNNTemp", "rebut"])
def test_unported_parts_raise(tmp_path, corpus, what, monkeypatch):
    """Each of these raised until it was ported and now runs.  The
    baselines: their recipe's config and seeded weights give the three
    files with the keys and lists of the JAX package's
    ``artifacts/cli_cycle/paper_plots/`` files (n_fft pinned: windows up to
    the training window; expt 2 in the "replace" mode), on the plain
    engine whatever ``PCAUDIO_FUSED_ATTN`` says, since they have no
    attention.  The rebuttal sweep (:func:`_check_rebut`)."""
    if what == "rebut":
        _check_rebut(tmp_path, corpus, monkeypatch)
        return
    monkeypatch.setenv("PCAUDIO_FUSED_ATTN", "0")
    cfg = RECIPES[what]()
    config = os.path.join(tmp_path, "config.json")
    with open(config, "w") as f:
        json.dump(cfg.to_reference_json(), f)
    torch.manual_seed(0)
    pth = os.path.join(tmp_path, "net.pth")
    export_reference_pth(cfg.build_model(), pth, cfg)
    out = os.path.join(tmp_path, "out")
    results, prov = _eval(corpus, config, "--pth", pth, "--out-dir", out)
    names = [f"{what}_expt1.json", f"{what}_randK_expt2.json",
             f"{what}_maxK_expt2.json"]
    assert sorted(results) == sorted(names)
    for name in names:
        got = _read(os.path.join(out, name))
        ref = _read(os.path.join(PAPER_PLOTS, name))
        assert list(got) == list(ref)
        for key in ref:
            if key != "data":
                assert got[key] == ref[key], (name, key)
        assert list(got["data"]) == list(ref["data"])
        assert all(len(v) == len(r) for v, r in zip(got["data"].values(),
                                                     ref["data"].values()))
        if "maxK" in name:
            assert all(v[1] == 0 for v in got["data"].values())
        side = _read(os.path.join(out, name.replace(".json", ".provenance.json")))
        assert side["engine"] == "plain" and "fused_gate" not in side
    assert _read(os.path.join(out, names[0]))["list_N"] == default_list_N(
        cfg.window_size, include_larger=False)
    assert prov["engine"] == "plain"


def _check_rebut(tmp_path, corpus, monkeypatch):
    """``--experiments rebut`` on a 3ST writes ``3ST_rebut_expt_{randK,
    maxK}.json`` with the keys of the committed JAX files, one window width
    (64) and the config's ``default_list_K(Nfft·Ntemp/2)``, each with its
    provenance; ``cli plots`` draws ``rebut_importance.pdf`` from them and
    the expt-2 files of the same run.  On an FST it says the sweep is
    3ST-only and writes nothing."""
    monkeypatch.delenv("PCAUDIO_FUSED_ATTN", raising=False)
    cfg, config = _config(tmp_path, ARCH_3ST)
    out = os.path.join(tmp_path, "out")
    results, prov = _eval(corpus, config, "--pth", _weights(tmp_path, cfg),
                          "--experiments", "expt2", "rebut", "--out-dir", out)
    names = ["3ST_rebut_expt_randK.json", "3ST_rebut_expt_maxK.json"]
    assert set(names) <= set(results)
    list_K = default_list_K(NFFT[ARCH_3ST] * 10 // 2)
    for name in names:
        got, ref = _read(os.path.join(out, name)), _read(os.path.join(PAPER_PLOTS, name))
        assert list(got) == list(ref) == ["data", "list_K"]
        assert list(got["data"]) == list(ref["data"]) == ["64"]
        assert got["list_K"] == list_K
        assert ref["list_K"] == default_list_K(5120)
        assert list(got["data"]["64"]) == [str(k) for k in list_K]
        for mean, var in got["data"]["64"].values():
            assert 0.0 <= mean <= 1.0 and var >= 0.0
            assert var == 0 or "randK" in name
        side = _read(os.path.join(out, name.replace(".json", ".provenance.json")))
        assert side["engine"] == "plain" and side["wall_s"] > 0
    paths = cli.main(["plots", "--results-dir", out, "--out-dir",
                      os.path.join(tmp_path, "figs")])
    assert [os.path.basename(p) for p in paths] == ["rebut_importance.pdf"]
    with open(paths[0], "rb") as f:
        assert f.read(5) == b"%PDF-"

    fcfg, fconfig = _config(tmp_path, ARCH_FST)
    fout = os.path.join(tmp_path, "fst")
    results, _ = _eval(corpus, fconfig, "--pth", _weights(tmp_path, fcfg),
                       "--experiments", "rebut", "--out-dir", fout)
    assert results == {} and os.listdir(fout) == []


@pytest.mark.parametrize("env,device,expect", [
    (None, "cpu", False), (None, "cuda", True), ("0", "cuda", False),
    ("0", "cpu", False), ("1", "cuda", True), ("1", "cpu", RuntimeError),
    ("yes", "cuda", ValueError)])
def test_fused_attn_choice(monkeypatch, env, device, expect):
    """Unset: K4 on a card, the plain attention on the CPU; "0": plain;
    "1": K4, an error on the CPU."""
    if env is None:
        monkeypatch.delenv("PCAUDIO_FUSED_ATTN", raising=False)
    else:
        monkeypatch.setenv("PCAUDIO_FUSED_ATTN", env)
    if isinstance(expect, bool):
        assert cli._fused_attn_choice(torch.device(device)) is expect
    else:
        with pytest.raises(expect):
            cli._fused_attn_choice(torch.device(device))


def test_fused_attn_on_the_cpu_raises_through_the_cli(tmp_path, corpus, monkeypatch):
    monkeypatch.setenv("PCAUDIO_FUSED_ATTN", "1")
    cfg, config = _config(tmp_path, ARCH_FST)
    with pytest.raises(RuntimeError, match="PCAUDIO_FUSED_ATTN=1"):
        _eval(corpus, config, "--pth", _weights(tmp_path, cfg))


class _Disagreeing(torch.nn.Module):
    """A model whose logits are its inner model's reversed: its argmax
    differs on every row whose top class is not also its bottom one."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, X, mask=None):
        return self.inner(X, mask).flip(-1)


def test_failing_gate_exits_nonzero(tmp_path, corpus, monkeypatch, capsys):
    """The fused model of the gate disagrees with the plain one: the run
    prints the gate's record and exits non-zero, writing no file."""
    cfg, config = _config(tmp_path, ARCH_FST)
    monkeypatch.setattr(cli, "_fused_attn_choice", lambda device: True)
    plain_model = cli._model
    monkeypatch.setattr(cli, "_model", lambda c, sd, fused, dev: (
        _Disagreeing(plain_model(c, sd, fused, dev)) if fused
        else plain_model(c, sd, fused, dev)))
    out = os.path.join(tmp_path, "out")
    with pytest.raises(SystemExit) as exc:
        _eval(corpus, config, "--pth", _weights(tmp_path, cfg), "--out-dir", out)
    assert exc.value.code not in (0, None)
    assert "parity gate failed" in str(exc.value.code)
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["agreement"][0] < record["agreement"][1]
    assert not os.path.exists(out)


def test_passing_gate_runs_the_fused_model_from_a_checkpoint(tmp_path, corpus,
                                                            monkeypatch):
    """With the fused engine chosen, the gate holds the fused-attention model
    (on the CPU, K4's wrapper sends it to the plain pair) against the plain
    one, passes, and the sweeps run on it; ``--checkpoint`` loads the port's
    own training checkpoint and gives the ``.pth``'s results."""
    cfg, config = _config(tmp_path, ARCH_FST)
    pth = _weights(tmp_path, cfg)
    torch.manual_seed(0)
    model = cfg.build_model()
    ckpt = os.path.join(tmp_path, "ckpt")
    save_checkpoint(ckpt, TrainState(model, torch.optim.Adam(model.parameters())),
                    cfg, step=3)
    monkeypatch.setattr(cli, "_fused_attn_choice", lambda device: True)
    got, prov = _eval(corpus, config, "--checkpoint", ckpt, "--experiments",
                      "expt2", "--out-dir", os.path.join(tmp_path, "a"))
    assert prov["engine"] == "fused" and prov["fused_gate"]["passed"]
    agree, total = prov["fused_gate"]["agreement"]
    assert agree == total and total == 2 * prov["fused_gate"]["rows"] > 0
    monkeypatch.setattr(cli, "_fused_attn_choice", lambda device: False)
    ref, _ = _eval(corpus, config, "--pth", pth, "--experiments", "expt2",
                   "--out-dir", os.path.join(tmp_path, "b"))
    # the same weights, the same random draws (seeded per microbatch), the
    # same arithmetic on the CPU
    assert got == ref
