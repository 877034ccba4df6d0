"""pcaudio_torch stands alone: it never imports jax, its kernels are built
by nvcc or not at all, and its wrappers send CPU tensors to their plain
versions."""
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pcaudio_torch.eval import TemporalPipelineConfig
from pcaudio_torch.nn import ST
from pcaudio_torch.ops.kernels import _build
from pcaudio_torch.ops.kernels.featurize import (
    fused_chunk_mag2, fused_chunk_mag2_plain)
from pcaudio_torch.ops.kernels.fused_st import (
    fused_st_forward, fused_st_forward_plain)
from pcaudio_torch.ops.kernels.select import (
    exact_topk_chunks, exact_topk_chunks_plain)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    """A fresh interpreter imports every module of the port, probes and
    the native loader included, builds the full-width 3ST classifier and
    serves one request of clips and one of WAV files,
    and takes two train steps through K4's route and two of each baseline
    (FB, CNNTemp) at full width, and two steps of each Set Transformer
    task (ModelNet40 from arrays, MoG clustering with its benchmark, max
    regression) with a remat step, on the CPU without loading jax or any
    module of the JAX package ``pcaudio``."""
    code = textwrap.dedent("""
        import dataclasses
        import importlib
        import pkgutil
        import sys
        import numpy as np
        import torch
        import pcaudio_torch
        mods = [m.name for m in pkgutil.walk_packages(pcaudio_torch.__path__,
                                                      "pcaudio_torch.")]
        assert "pcaudio_torch.probes.st_launch" in mods, mods
        assert "pcaudio_torch.native" in mods, mods
        assert {"pcaudio_torch.ops.subsample",
                "pcaudio_torch.probes.rebut_sweep"} <= set(mods), mods
        assert {"pcaudio_torch.tasks.modelnet40", "pcaudio_torch.tasks.clustering",
                "pcaudio_torch.tasks.max_regression",
                "pcaudio_torch.data.modelnet40", "pcaudio_torch.utils.metrics",
                "pcaudio_torch.utils.params", "pcaudio_torch.utils.debugging",
                "pcaudio_torch.utils.profiling"} <= set(mods), mods
        for name in mods:
            importlib.import_module(name)
        from pcaudio_torch.eval import TemporalPipelineConfig
        from pcaudio_torch.nn import ST
        from pcaudio_torch.serve import AudioClassifier
        import pcaudio_torch.core, pcaudio_torch.checkpoint, pcaudio_torch.dsp
        import pcaudio_torch.cli, pcaudio_torch.ops.cloud
        from pcaudio_torch.train import (
            RECIPES, build_trainer, fit, make_train_step)

        torch.manual_seed(0)
        model = ST(dim_input=3, dim_output=10, num_inds=64, dim_hidden=64,
                   num_heads=8)
        cfg = TemporalPipelineConfig(top_k=128, stft_precision="default",
                                     compute_dtype="bfloat16")
        clf = AudioClassifier(model=model, pipeline=cfg, batch_size=2,
                              device="cpu")
        clip = (0.1 * np.random.default_rng(0).standard_normal(220500)
                ).astype(np.float32)
        lg = clf.logits([clip])
        assert lg.shape == (1, 10) and np.isfinite(lg).all(), lg
        import os, tempfile
        from pcaudio_torch.data.synthetic import write_wav_pcm16
        wav = os.path.join(tempfile.mkdtemp(), "clip.wav")
        write_wav_pcm16(wav, clip)
        labels, probs = clf.classify_paths([wav])
        clf.close()
        assert labels.shape == (1,) and np.isfinite(probs).all()

        cfg = dataclasses.replace(RECIPES["FST"](), dhidden=8, nheads=2,
                                  ninds=4, batch_size=4)
        state, apply_fn = build_trainer(cfg, "cpu", fused_attn=True)
        data = {"points": np.zeros((8, 16, 2), np.float32),
                "labels": np.zeros(8, np.int32)}
        state, hist = fit(state, make_train_step(apply_fn, state.optimizer),
                          data, batch_size=4, epochs=1, log=lambda s: None)
        assert state.step == 2 and np.isfinite(hist[0]["train_loss"])
        for name, shape in (("FB", (8, 1025)), ("CNNTemp", (8, 10, 512))):
            cfg = dataclasses.replace(RECIPES[name](), batch_size=4)
            state, apply_fn = build_trainer(cfg, "cpu")
            data = {"x": np.zeros(shape, np.float32),
                    "labels": np.zeros(8, np.int32)}
            state, hist = fit(state, make_train_step(apply_fn, state.optimizer),
                              data, batch_size=4, epochs=1, log=lambda s: None)
            assert state.step == 2 and np.isfinite(hist[0]["train_loss"])
            step = make_train_step(apply_fn, state.optimizer, remat=True,
                                   generator=state.generator)
            assert np.isfinite(step({k: torch.from_numpy(v[:4])
                                     for k, v in data.items()})["loss"].item())
        from pcaudio_torch.data import ModelNet40Fetcher
        from pcaudio_torch.tasks import clustering, max_regression, modelnet40
        from pcaudio_torch.utils import count_parameters
        rng = np.random.default_rng(0)
        clouds = rng.standard_normal((24, 40, 3)).astype(np.float32)
        fetcher = ModelNet40Fetcher.from_arrays(clouds, np.arange(24) % 2, clouds,
                                                np.arange(24) % 2, 8, down_sample=4)
        mcfg = modelnet40.ModelNet40Config(num_pts=10, dim=8, n_heads=2, n_anc=4,
                                           batch_size=8, dim_output=2)
        state, hist = modelnet40.train(mcfg, fetcher, epochs=1,
                                       log=lambda s: None, device="cpu")
        assert state.step == 2 and "test_accuracy" in hist[0]
        ccfg = clustering.ClusteringConfig(model="deepset", K=2, B=2, N_min=5,
                                           N_max=9)
        model, _, _ = clustering.train(ccfg, num_steps=2, log=lambda s: None,
                                       device="cpu")
        assert np.isfinite(clustering.benchmark(model, ccfg, num_batches=1)).all()
        st = max_regression.SmallSetTransformer(8, 2)
        assert np.isfinite(max_regression.train(st, steps=2, device="cpu")[1])
        assert count_parameters(st, display=False) > 0
        import pcaudio_torch.eval.plots
        assert "jax" not in sys.modules, "pcaudio_torch imported jax"
        jaxpkg = [m for m in sys.modules
                  if m == "pcaudio" or m.startswith("pcaudio.")]
        assert not jaxpkg, f"pcaudio_torch imported {jaxpkg}"
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    """Static check of every source file of the port and of chip_smoke.py:
    no ``import jax`` / ``import pcaudio`` / ``from pcaudio.`` line, and no
    C++ or CUDA source that includes a file of the JAX package."""
    bad = re.compile(r"^\s*(import\s+(jax|pcaudio)\b(?!_)|from\s+(jax|pcaudio)(\.|\s))")
    bad_c = re.compile(r"^\s*#\s*include\s*[<\"](\.\./)*pcaudio/")
    files = [os.path.join(REPO, "chip_smoke.py")]
    c_files = []
    for root, _, names in os.walk(os.path.join(REPO, "pcaudio_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
        c_files += [os.path.join(root, n) for n in names
                    if n.endswith((".cpp", ".cu", ".cuh"))]
    assert len(files) > 30
    assert os.path.join(REPO, "pcaudio_torch", "native", "__init__.py") in files
    assert os.path.join(REPO, "pcaudio_torch", "native", "wav_loader.cpp") in c_files
    hits = [f"{os.path.relpath(f, REPO)}:{i}: {line.strip()}"
            for pattern, group in ((bad, files), (bad_c, c_files))
            for f in group for i, line in enumerate(open(f), 1)
            if pattern.match(line)]
    assert not hits, hits
    assert bad.match("from pcaudio.data import x") and bad.match("import jax.numpy")
    assert not bad.match("from pcaudio_torch.data import x")
    assert bad_c.match('#include "pcaudio/native/x.h"')
    assert not bad_c.match('#include "common.cuh"')


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    """AudioClassifier, build_trainer, prepare_*_data and the tasks'
    ``build`` and ``train`` run on "cuda" unless the caller names the CPU;
    without a card they raise instead of running on the CPU."""
    import dataclasses
    import inspect

    from pcaudio_torch.serve import AudioClassifier
    from pcaudio_torch.tasks import clustering, max_regression, modelnet40
    from pcaudio_torch.train import recipes

    fns = (recipes.build_trainer, recipes.prepare_framewise_data,
           recipes.prepare_temporal_data)
    tasks = (modelnet40.build, modelnet40.train, clustering.build,
             clustering.train, max_regression.train)
    for fn in fns + tasks:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    fields = {f.name: f.default for f in dataclasses.fields(AudioClassifier)}
    assert fields["device"] == "cuda"

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = recipes.RECIPES["FST"]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recipes.build_trainer(cfg)
    waves = np.zeros((1, 4096), np.float32)
    lengths, labels = np.array([4096]), np.array([0])
    for prep in fns[1:]:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prep(waves, lengths, labels, recipes.RECIPES["3ST"]())
    model = ST(dim_input=3, dim_output=10, num_inds=4, dim_hidden=8, num_heads=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AudioClassifier(model=model, pipeline=TemporalPipelineConfig(top_k=64))
    for call in (lambda: modelnet40.build(modelnet40.ModelNet40Config()),
                 lambda: clustering.train(clustering.ClusteringConfig(), num_steps=1),
                 lambda: max_regression.train(max_regression.SmallDeepSet(), steps=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_wrappers_send_cpu_tensors_to_plain_versions():
    counts = [f.launches for f in (fused_chunk_mag2, exact_topk_chunks,
                                   fused_st_forward)]
    rng = np.random.default_rng(0)
    waves = torch.from_numpy((0.1 * rng.standard_normal((2, 16384))
                              ).astype(np.float32))
    lengths = torch.tensor([16384, 9000], dtype=torch.int32)
    m2, cm = fused_chunk_mag2(waves, lengths)
    r2, rm = fused_chunk_mag2_plain(waves, lengths)
    assert torch.equal(m2, r2) and torch.equal(cm, rm)

    mags = m2.reshape(-1, *m2.shape[2:])
    v, i = exact_topk_chunks(mags, 64)
    rv, ri = exact_topk_chunks_plain(mags, 64)
    assert torch.equal(v, rv) and torch.equal(i, ri)

    torch.manual_seed(0)
    model = ST(dim_input=3, dim_output=10, num_inds=8, dim_hidden=16,
               num_heads=4).eval()
    pts = torch.randn(4, 64, 3)
    mask = torch.arange(64)[None, :] < torch.tensor([64, 10, 1, 0])[:, None]
    assert torch.equal(fused_st_forward(model, pts, mask),
                       fused_st_forward_plain(model, pts, mask))
    assert [f.launches for f in (fused_chunk_mag2, exact_topk_chunks,
                                 fused_st_forward)] == counts


@pytest.mark.parametrize("field,value", [("featurize", "xla"),
                                         ("extraction", "approx"),
                                         ("target_fs", 16000)])
def test_unported_pipeline_options_raise(field, value):
    """Of the JAX options, only ``extraction="approx"`` is not ported and
    raises.  ``featurize="xla"`` and resampling, which raised until they
    were ported, now pass (``top_k`` set or None); resampling, another hop
    or another window with the fused featurize raise ``ValueError``, as the
    JAX package asserts."""
    for top_k in (64, None):
        cfg = TemporalPipelineConfig(top_k=top_k, **{field: value})
        if field == "extraction":
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                cfg.check_ported()
            continue
        TemporalPipelineConfig(top_k=top_k, **{"featurize": "xla",
                                               field: value}).check_ported()
        if field == "target_fs":
            with pytest.raises(ValueError, match="featurize='xla'"):
                cfg.check_ported()
    for bad in (dict(hop_factor=0.25), dict(win_length=512)):
        with pytest.raises(ValueError, match="featurize='xla'"):
            TemporalPipelineConfig(**bad).check_ported()
        TemporalPipelineConfig(featurize="xla", **bad).check_ported()
