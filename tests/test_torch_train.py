"""The port's training path (pcaudio_torch.train, .checkpoint, .cli) against
the JAX package's: gradients through K4's plain pair, train steps, the
batch order, checkpoint resume, serving a saved 3ST, and learning.  Weights
cross from JAX through st_state_dict_from_jax; inputs come from numpy
seeds."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pcaudio.nn import ST as JaxST
from pcaudio.train import TrainState as JaxTrainState
from pcaudio.train import adam_l2, make_train_step as jax_make_train_step
from pcaudio.train import pointcloud_apply as jax_pointcloud_apply
from pcaudio.train.loop import _batches as jax_batches
from pcaudio_torch.checkpoint import (
    export_reference_pth, latest_step, save_checkpoint, st_state_dict_from_jax)
from pcaudio_torch.cli import main as cli_main
from pcaudio_torch.core.config import ARCH_3ST, ExperimentConfig
from pcaudio_torch.eval import TemporalPipelineConfig
from pcaudio_torch.nn import ST, BaselineFF, CNNClassifier
from pcaudio_torch.serve import AudioClassifier
from pcaudio_torch.tasks.modelnet40 import ModelNet40Config, build as build_mn40
from pcaudio_torch.train import (
    RECIPES, TrainState, build_trainer, fit, make_eval_step, make_train_step,
    pointcloud_apply)


def _synthetic_sets(rng, n, k=32):
    """tests/test_train.py::_synthetic_sets: clouds centered at +1 vs -1."""
    labels = rng.integers(0, 2, n)
    centers = np.where(labels[:, None, None] == 1, 1.0, -1.0)
    points = centers + 0.1 * rng.standard_normal((n, k, 2))
    return points.astype(np.float32), labels.astype(np.int32)


def _jax_and_port(din=3, ncls=10, fused_attn=True):
    """A JAX ST(fused_attn=False) from its own init, and the port's ST
    carrying the same weights."""
    jm = JaxST(dim_input=din, dim_output=ncls, num_inds=8, dim_hidden=16,
               num_heads=4)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8, din)))
    tm = ST(dim_input=din, dim_output=ncls, num_inds=8, dim_hidden=16,
            num_heads=4, fused_attn=fused_attn)
    tm.load_state_dict(st_state_dict_from_jax(jax.device_get(params)))
    return jm, params, tm


def _ragged(rng, B=4, K=24, din=3):
    """test_fused_attn_model_grads_match's batch: ragged point masks."""
    pts = rng.standard_normal((B, K, din)).astype(np.float32)
    counts = np.array([K, K - 5, 10, 3])[:B]
    mask = np.arange(K)[None, :] < counts[:, None]
    return pts, mask, rng.integers(0, 10, B).astype(np.int32)


def test_fused_attn_model_loss_and_grads_match_jax():
    """Port ST(fused_attn=True) (K4's plain pair on the CPU) vs jax.grad of
    the JAX XLA-attention ST: loss and every parameter gradient at 1e-4."""
    jm, params, tm = _jax_and_port()
    pts, mask, labels = _ragged(np.random.default_rng(1))

    def loss(p):
        lp = jax.nn.log_softmax(jm.apply(p, jnp.asarray(pts),
                                         mask=jnp.asarray(mask)))
        return -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(labels)[:, None],
                                             axis=1))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss))(params)
    ref_grads = st_state_dict_from_jax(jax.device_get(ref_grads))
    got = torch.nn.functional.cross_entropy(
        tm(torch.from_numpy(pts), torch.from_numpy(mask)),
        torch.from_numpy(labels).long())
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref_loss), rtol=1e-4)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_train_steps_match_jax(opt):
    """10 steps from the same weights on the same batches.  Losses within
    rtol 1e-4; under SGD the parameters within 1e-5 (under Adam, m/sqrt(v)
    of near-zero gradients amplifies summation-order noise, as
    tests/test_train.py says)."""
    jm, params, tm = _jax_and_port()
    rng = np.random.default_rng(2)
    batches = [dict(zip(("points", "mask", "labels"), _ragged(rng)))
               for _ in range(10)]
    if opt == "adam":
        jopt = adam_l2(1e-3, weight_decay=1e-3)
        topt = torch.optim.Adam(tm.parameters(), lr=1e-3, weight_decay=1e-3)
    else:
        jopt = optax.sgd(1e-2)
        topt = torch.optim.SGD(tm.parameters(), lr=1e-2)
    jstep = jax.jit(jax_make_train_step(jax_pointcloud_apply(jm), jopt))
    tstep = make_train_step(pointcloud_apply(tm), topt)
    state = JaxTrainState.create(params, jopt)
    for i, b in enumerate(batches):
        state, jm_metrics = jstep(state, {k: jnp.asarray(v) for k, v in b.items()},
                                  jax.random.key(i))
        t_metrics = tstep({k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(t_metrics["loss"].item(),
                                   float(jm_metrics["loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
    if opt == "sgd":
        ref = st_state_dict_from_jax(jax.device_get(state.params))
        for name, p in tm.state_dict().items():
            np.testing.assert_allclose(p.numpy(), ref[name].numpy(),
                                       atol=1e-5, rtol=0, err_msg=name)


def test_fit_batch_order_matches_jax():
    """fit draws exactly JAX _batches' indices, epoch after epoch."""
    n, bs, seed, epochs = 53, 8, 7, 3
    seen = []

    def record(batch):
        seen.append(batch["labels"].numpy().copy())
        return {"loss": torch.zeros(()), "accuracy": torch.zeros(())}

    model = torch.nn.Linear(1, 1)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    data = {"labels": np.arange(n, dtype=np.int32),
            "x": np.zeros((n, 1), np.float32)}
    fit(state, record, data, batch_size=bs, epochs=epochs, seed=seed,
        log=lambda s: None)
    rng = np.random.default_rng(seed)
    ref = [idx for _ in range(epochs) for idx in jax_batches(n, bs, rng)]
    assert len(seen) == len(ref) == epochs * (n // bs)
    for a, b in zip(seen, ref):
        np.testing.assert_array_equal(a, b)
    assert state.step == len(ref)


def _tiny_fst():
    return dataclasses.replace(RECIPES["FST"](), dhidden=8, nheads=2, ninds=4,
                               classes=2, batch_size=16, epochs=4)


def _fit_tiny(cfg, data, ckpt, epochs, resume=False, seed_offset=0):
    state, apply_fn = build_trainer(
        dataclasses.replace(cfg, torch_seed=cfg.torch_seed + seed_offset),
        "cpu")
    state, hist = fit(state, make_train_step(apply_fn, state.optimizer),
                      data, batch_size=cfg.batch_size, epochs=epochs,
                      seed=cfg.numpy_seed, checkpoint_dir=ckpt,
                      checkpoint_every=2, config=cfg, resume=resume,
                      log=lambda s: None)
    return state, hist


def test_resume_continues_bit_for_bit(tmp_path):
    """Train 4 epochs straight; train 2, then resume a fresh model (other
    init) to 4 from the epoch-2 checkpoint: identical weights, optimizer
    step count and losses."""
    cfg = _tiny_fst()
    pts, lbl = _synthetic_sets(np.random.default_rng(3), 48, k=12)
    data = {"points": pts, "labels": lbl}
    full, full_hist = _fit_tiny(cfg, data, str(tmp_path / "a"), 4)
    _fit_tiny(cfg, data, str(tmp_path / "b"), 2)
    assert latest_step(str(tmp_path / "b")) == 2
    resumed, hist = _fit_tiny(cfg, data, str(tmp_path / "b"), 4, resume=True,
                              seed_offset=1)
    assert [r["epoch"] for r in hist] == [2, 3]
    assert [r["step_losses"] for r in hist] == [
        r["step_losses"] for r in full_hist[2:]]
    assert resumed.step == full.step
    for (name, a), b in zip(full.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert latest_step(str(tmp_path / "b")) == 4


def test_saved_3st_serves_through_reference_checkpoint(tmp_path):
    """A 3ST saved as a training checkpoint + reference .pth loads through
    AudioClassifier.from_reference_checkpoint and classifies as the model
    it was saved from."""
    cfg = ExperimentConfig(architecture=ARCH_3ST, window_size=1024, Ntemp=10,
                           dhidden=16, nheads=4, ninds=8, batch_size=16)
    state, _ = build_trainer(cfg, "cpu")
    model = state.model
    save_checkpoint(str(tmp_path), state, cfg, step=1)
    export_reference_pth(model, str(tmp_path / "3ST_net.pth"), cfg)
    sd = torch.load(str(tmp_path / "3ST_net.pth"))
    assert all(k.startswith("module.") for k in sd)
    clf = AudioClassifier.from_reference_checkpoint(
        str(tmp_path / "reference_config.json"), str(tmp_path / "3ST_net.pth"),
        top_k=64, batch_size=2, buffer_len=32768, device="cpu")
    rng = np.random.default_rng(4)
    clips = [(0.2 * rng.standard_normal(n)).astype(np.float32)
             for n in (30000, 20000)]
    direct = AudioClassifier(model=model, pipeline=TemporalPipelineConfig(
        top_k=64), batch_size=2, buffer_len=32768, device="cpu")
    np.testing.assert_array_equal(clf.logits(clips), direct.logits(clips))


def test_fst_recipe_learns_synthetic_sets():
    """The FST recipe at small width, K4's plain pair on, learns
    tests/test_train.py's two-class sets."""
    cfg = dataclasses.replace(_tiny_fst(), dhidden=16, nheads=4, ninds=8,
                              batch_size=32)
    pts, lbl = _synthetic_sets(np.random.default_rng(1), 64)
    state, apply_fn = build_trainer(cfg, "cpu", fused_attn=True)
    state, hist = fit(state, make_train_step(apply_fn, state.optimizer),
                      {"points": pts, "labels": lbl}, batch_size=32,
                      epochs=30, eval_data={"points": pts, "labels": lbl},
                      eval_step=make_eval_step(apply_fn), eval_every=29,
                      log=lambda s: None)
    assert state.step == 60
    assert hist[-1]["step_losses"][-1] < 0.5 * hist[0]["step_losses"][0]
    assert hist[-1]["test_accuracy"] > 0.9


def test_build_trainer_routes_by_device():
    state, _ = build_trainer(_tiny_fst(), "cpu")
    assert not any(getattr(m, "fused_attn", False) for m in state.model.modules())
    assert state.generator is None
    state, _ = build_trainer(_tiny_fst(), "cpu", fused_attn=True)
    assert all(m.fused_attn for m in state.model.modules()
               if hasattr(m, "fused_attn"))


@pytest.mark.parametrize("recipe", ["FB", "CNNTemp"])
def test_unported_recipes_raise(recipe):
    """The FB and CNNTemp recipes raised until their models were ported;
    now ``build_trainer`` gives the recipe's baseline at full width, its
    Adam, and a state whose dropout generator, the one its adapter draws
    from, is seeded from the config's ``torch_seed``: two trainers draw the
    same masks."""
    cfg = RECIPES[recipe]()
    outs = []
    for _ in range(2):
        state, apply_fn = build_trainer(cfg, "cpu")
        model, opt = state.model, state.optimizer
        assert isinstance(model, BaselineFF if recipe == "FB" else CNNClassifier)
        assert opt.defaults["lr"] == cfg.learning_rate
        assert opt.defaults["weight_decay"] == cfg.weight_decay
        assert state.generator.initial_seed() == cfg.torch_seed
        shape = (4, 1025) if recipe == "FB" else (4, 10, 512)
        seed_state = state.generator.get_state()
        with torch.no_grad():
            outs.append(apply_fn({"x": torch.ones(shape)}, train=True))
        assert not torch.equal(state.generator.get_state(), seed_state)
        assert model.training
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*(build_trainer(cfg, "cpu")[0].model.state_dict().values()
                      for _ in range(2))):
        assert torch.equal(a, b)


def test_cli_train_needs_cuda_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the message on a machine without CUDA")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli_main(["train", "FST", "--esc-csv", "x.csv", "--esc-audio", "a",
                  "--out-dir", str(tmp_path)])


def _remat_case(kind):
    """Two identical trainers ``(state, apply_fn)`` and a batch: a
    3ST-shaped ST through K4's route (the plain pair on the CPU) on ragged
    masks; the FB baseline, whose input dropout draws from the state's
    generator; or the ModelNet40 Set Transformer, whose dropouts act on
    activations inside the network."""
    rng = np.random.default_rng(6)
    if kind == "st_k4":
        cfg = dataclasses.replace(RECIPES["3ST"](), dhidden=16, nheads=4,
                                  ninds=8, batch_size=4)
        pts, mask, labels = _ragged(rng)
        batch = {"points": torch.from_numpy(pts), "mask": torch.from_numpy(mask),
                 "labels": torch.from_numpy(labels)}
        return [build_trainer(cfg, "cpu", fused_attn=True) for _ in range(2)], batch
    if kind == "fb_dropout":
        cfg = dataclasses.replace(RECIPES["FB"](), layers=[33, 16], batch_size=8)
        batch = {"x": torch.from_numpy(rng.standard_normal((8, 33)).astype(np.float32)),
                 "labels": torch.from_numpy(rng.integers(0, 10, 8))}
        return [build_trainer(cfg, "cpu") for _ in range(2)], batch
    cfg = ModelNet40Config(dim=16, n_heads=4, n_anc=4, dim_output=5)
    trainers = []
    for _ in range(2):
        model, optimizer = build_mn40(cfg, "cpu")
        generator = torch.Generator().manual_seed(3)

        def apply_fn(batch, train=False, model=model, generator=generator):
            model.train(train)
            return model(batch["points"], generator=generator)

        trainers.append((TrainState(model, optimizer, generator=generator),
                         apply_fn))
    batch = {"points": torch.from_numpy(rng.standard_normal((6, 20, 3)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 5, 6))}
    return trainers, batch


def _blocks(model):
    """The modules a remat step checkpoints one by one: the ST's two ISABs
    and its PMA; every module of the ModelNet40 Set Transformer, its two
    dropouts included."""
    if isinstance(model, ST):
        return [model.enc[0], model.enc[1], model.dec[0]]
    return [*model.enc, *model.dec]


@pytest.mark.parametrize("kind,form", [
    ("st_k4", "whole"), ("st_k4", "blocks"), ("fb_dropout", "whole"),
    ("mn40_dropout", "whole"), ("mn40_dropout", "blocks")])
def test_remat_train_step_matches_plain(kind, form):
    """``remat`` (the whole forward, or each block, under
    torch.utils.checkpoint, recomputed in the backward) gives the plain
    step's loss and updated weights, as tests/test_train.py checks the JAX
    step: loss to 1e-6 and weights to 1e-6 over three steps; with dropout
    the recompute draws the forward's masks from the restored generator,
    which ends where the plain step's does."""
    ((plain, plain_fn), (rem, rem_fn)), batch = _remat_case(kind)
    remat = True if form == "whole" else _blocks(rem.model)
    steps = (make_train_step(plain_fn, plain.optimizer),
             make_train_step(rem_fn, rem.optimizer, remat=remat,
                             generator=rem.generator))
    assert (plain.generator is None) == (kind == "st_k4")
    for _ in range(3):
        mp, mr = (s(batch) for s in steps)
        np.testing.assert_allclose(mr["loss"].item(), mp["loss"].item(), rtol=1e-6)
    for (name, a), b in zip(plain.model.state_dict().items(),
                            rem.model.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=name)
    if plain.generator is not None:
        assert torch.equal(plain.generator.get_state(), rem.generator.get_state())
    assert not any("forward" in vars(m) for m in rem.model.modules())


def test_remat_step_raises_on_a_generator_it_cannot_restore():
    """A dropout model whose generator the remat step was not given: the
    forward raises before any update, where the recompute would otherwise
    draw other masks and take the gradient of another network."""
    ((state, apply_fn), _), batch = _remat_case("mn40_dropout")
    before = [p.detach().clone() for p in state.model.parameters()]
    other = torch.Generator().manual_seed(0)
    for remat in (True, _blocks(state.model)):
        for generator in (None, other):
            step = make_train_step(apply_fn, state.optimizer, remat=remat,
                                   generator=generator)
            with pytest.raises(RuntimeError, match="generator"):
                step(batch)
    assert not any("forward" in vars(m) for m in state.model.modules())
    assert all(torch.equal(a, b) for a, b in zip(before, state.model.parameters()))
    assert make_train_step(apply_fn, state.optimizer)(batch)["loss"].isfinite()
