"""The baselines' training path in the port (FB and CNN_temp: configs,
data preparation, the train step, resume, ``cli train``) against the JAX
package's, on the CPU, from numpy inputs and JAX weights carried by the
``*_state_dict_from_jax`` functions.

Dropout masks cannot match ``jax.random``: the step is compared with
dropout off (p = 0 on both sides), and dropout itself by its rate, scale
and seeded repeat (tests/test_torch_models.py) and by a resumed run drawing
the masks of an unbroken one (here)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcaudio.nn import BaselineFF as JaxBaselineFF
from pcaudio.nn import CNNClassifier as JaxCNN
from pcaudio.train import TrainState as JaxTrainState
from pcaudio.train import adam_l2, make_train_step as jax_make_train_step
from pcaudio.train import recipes as jax_recipes
from pcaudio.train.glue import dropout_apply as jax_dropout_apply
from pcaudio_torch.checkpoint import (
    baseline_ff_state_dict_from_jax, cnn_classifier_state_dict_from_jax,
    latest_step)
from pcaudio_torch.cli import main as cli_main
from pcaudio_torch.core.config import ARCH_CNN, ARCH_FB, ExperimentConfig
from pcaudio_torch.data import generate_esc_corpus
from pcaudio_torch.nn import BaselineFF, CNNClassifier
from pcaudio_torch.train import (
    RECIPES, build_trainer, dropout_apply, fit, make_eval_step,
    make_train_step, recipes)
from test_torch_recipes import _assert_logmag_close, _clips


@pytest.mark.parametrize("recipe", ["FB", "CNNTemp"])
def test_reference_json_matches_jax(recipe):
    """``to_reference_json`` writes the JAX package's schema key for key
    (FB: ``numpy_seed``, ``layers``; CNN: ``np_seed``, ``Nt``, ``Nf``,
    ``layer_dims``) and reads back through the aliases."""
    cfg = RECIPES[recipe]()
    got = cfg.to_reference_json()
    ref = jax_recipes.RECIPES[recipe]().to_reference_json()
    assert list(got) == list(ref) and got == ref
    if recipe == "FB":
        assert "numpy_seed" in got and got["layers"] == [1025, 513, 256]
    else:
        assert "np_seed" in got and got["layer_dims"] == [512, 256, 100]
        assert (got["Nt"], got["Nf"], got["learning_rate"]) == (10, 512, 1e-4)
    assert ExperimentConfig.from_reference_json(got) == cfg
    assert ExperimentConfig.from_reference_json(json.loads(json.dumps(got))) == cfg


@pytest.mark.parametrize("recipe", ["FB", "CNNTemp"])
def test_prepared_data_matches_jax(recipe):
    """``as_clouds=False``: FB frames ``x [Nf, 1025]`` and CNN chunks ``x
    [Nc, 10, 512]`` against the JAX package's, labels identical and the
    log-magnitudes as tests/test_torch_recipes.py holds them."""
    waves, lengths, labels = _clips()
    cfg, jcfg = RECIPES[recipe](), jax_recipes.RECIPES[recipe]()
    framewise = recipe == "FB"
    prep = recipes.prepare_framewise_data if framewise else recipes.prepare_temporal_data
    jprep = (jax_recipes.prepare_framewise_data if framewise
             else jax_recipes.prepare_temporal_data)
    got = prep(waves, lengths, labels, cfg, "cpu", as_clouds=False)
    ref = jprep(waves, lengths, labels, jcfg, as_clouds=False)
    assert list(got) == list(ref) == ["x", "labels"]
    assert got["x"].shape == ref["x"].shape
    assert got["x"].shape[1:] == ((1025,) if framewise else (10, 512))
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    _assert_logmag_close(got["x"].reshape(len(got["x"]), -1),
                         np.asarray(ref["x"]).reshape(len(ref["x"]), -1))
    # the default chooses by the model: a grid for a baseline
    again = recipes.prepare_data(waves, lengths, labels, cfg, device="cpu")
    np.testing.assert_array_equal(again["x"], got["x"])


def _models(framewise):
    """A JAX baseline with dropout 0 from its own init and the port's with
    the same weights."""
    if framewise:
        jm = JaxBaselineFF(layer_dims=(129, 64, 32), nclasses=10, p=0.0)
        params = jm.init(jax.random.key(0), jnp.zeros((1, 129)))
        tm = BaselineFF((129, 64, 32), nclasses=10, p=0.0)
        tm.load_state_dict(baseline_ff_state_dict_from_jax(jax.device_get(params)))
        shape = (16, 129)
    else:
        jm = JaxCNN(Nt=10, Nf=64, layer_dims=(64, 32, 16), nclass=10, p=0.0)
        params = jm.init(jax.random.key(0), jnp.zeros((1, 10, 64)))
        tm = CNNClassifier(10, 64, (64, 32, 16), nclass=10, p=0.0)
        tm.load_state_dict(cnn_classifier_state_dict_from_jax(jax.device_get(params)))
        shape = (16, 10, 64)
    return jm, params, tm, shape


@pytest.mark.parametrize("model", ["FB", "CNN"])
def test_train_step_matches_jax(model):
    """Three Adam (lr 1e-3, wd 1e-3: ``adam_l2``) steps through the
    baselines' adapters, dropout off: losses within rtol 1e-5, and the
    updated parameters within 1e-6 (FB: through the double softmax)."""
    framewise = model == "FB"
    jm, params, tm, shape = _models(framewise)
    rng = np.random.default_rng(6)
    jopt = adam_l2(1e-3, weight_decay=1e-3)
    topt = torch.optim.Adam(tm.parameters(), lr=1e-3, weight_decay=1e-3)
    jstep = jax.jit(jax_make_train_step(jax_dropout_apply(jm), jopt))
    tstep = make_train_step(dropout_apply(tm, torch.Generator()), topt)
    state = JaxTrainState.create(params, jopt)
    for i in range(3):
        x = (3.0 * rng.standard_normal(shape) - 8.0).astype(np.float32)
        y = rng.integers(0, 10, shape[0]).astype(np.int32)
        state, jmet = jstep(state, {"x": jnp.asarray(x), "labels": jnp.asarray(y)},
                            jax.random.key(i))
        tmet = tstep({"x": torch.from_numpy(x), "labels": torch.from_numpy(y)})
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
    to_sd = baseline_ff_state_dict_from_jax if framewise else cnn_classifier_state_dict_from_jax
    ref = to_sd(jax.device_get(state.params))
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


def _tiny_fb():
    return dataclasses.replace(RECIPES["FB"](), layers=[33, 16], batch_size=8,
                               classes=3)


def _fit_fb(cfg, data, ckpt, epochs, resume=False, seed_offset=0):
    state, apply_fn = build_trainer(
        dataclasses.replace(cfg, torch_seed=cfg.torch_seed + seed_offset), "cpu")
    return fit(state, make_train_step(apply_fn, state.optimizer), data,
               batch_size=cfg.batch_size, epochs=epochs, seed=cfg.numpy_seed,
               eval_data=data, eval_step=make_eval_step(apply_fn), eval_every=1,
               checkpoint_dir=ckpt, checkpoint_every=2, config=cfg,
               resume=resume, log=lambda s: None)


def test_resume_draws_the_masks_of_an_unbroken_run(tmp_path):
    """FB with dropout 0.5: 4 epochs straight; 2, then a fresh trainer
    (other weights, other generator seed) resumed to 4 from the epoch-2
    checkpoint, which holds the generator's state: identical weights and
    losses.  Eval between epochs draws no mask."""
    cfg = _tiny_fb()
    rng = np.random.default_rng(8)
    data = {"x": rng.standard_normal((40, 33)).astype(np.float32),
            "labels": rng.integers(0, 3, 40).astype(np.int32)}
    full, full_hist = _fit_fb(cfg, data, str(tmp_path / "a"), 4)
    _fit_fb(cfg, data, str(tmp_path / "b"), 2)
    assert latest_step(str(tmp_path / "b")) == 2
    assert "generator" in torch.load(str(tmp_path / "b" / "step_2.pt"))
    resumed, hist = _fit_fb(cfg, data, str(tmp_path / "b"), 4, resume=True,
                            seed_offset=1)
    assert [r["epoch"] for r in hist] == [2, 3]
    assert [r["step_losses"] for r in hist] == [r["step_losses"] for r in full_hist[2:]]
    assert [r["test_accuracy"] for r in hist] == [
        r["test_accuracy"] for r in full_hist[2:]]
    for (name, a), b in zip(full.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(full.generator.get_state(), resumed.generator.get_state())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two classes of the synthetic corpus, four 5 s clips each: two of
    the CNN recipe's 128-chunk batches need 256 train chunks."""
    from pcaudio_torch.data.esc import ESC10_CATEGORIES
    root = tmp_path_factory.mktemp("corpus")
    return generate_esc_corpus(str(root), clips_per_class=4,
                               categories=ESC10_CATEGORIES[:2], clip_seconds=5.0)


@pytest.mark.parametrize("recipe", ["FB", "CNNTemp"])
def test_cli_train_writes_a_reference_checkpoint(tmp_path, corpus, recipe):
    """``cli train FB|CNNTemp --device cpu``: two full-width steps with
    finite losses, the training checkpoint with the generator's state, the
    reference config, and a ``.pth`` without the ``module.`` prefix (as the
    reference saves its baselines) that loads strictly into the config's
    model."""
    csv, audio = corpus
    out = str(tmp_path / recipe)
    state, hist = cli_main(["train", recipe, "--esc-csv", csv, "--esc-audio", audio,
                            "--out-dir", out, "--epochs", "1", "--max-steps", "2",
                            "--device", "cpu"])
    losses = hist[0]["step_losses"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert state.generator is not None
    assert sorted(os.listdir(out)) == sorted(
        [f"{recipe}_net.pth", "reference_config.json", "step_1.pt"])
    with open(os.path.join(out, "reference_config.json")) as f:
        ref_json = json.load(f)
    cfg = ExperimentConfig.from_reference_json(ref_json)
    assert cfg.architecture == (ARCH_FB if recipe == "FB" else ARCH_CNN)
    assert ref_json == dataclasses.replace(RECIPES[recipe](),
                                           epochs=1).to_reference_json()
    sd = torch.load(os.path.join(out, f"{recipe}_net.pth"))
    assert not any(k.startswith("module.") for k in sd)
    model = cfg.build_model()
    model.load_state_dict(sd)
    for k, v in state.model.state_dict().items():
        assert torch.equal(sd[k], v), k
