"""The port's Set Transformer tasks (pcaudio_torch.tasks, .data.modelnet40,
the MoG figures and their cli commands) against the JAX package's on the
CPU: the ModelNet40 fetcher batch for batch, the MoG functions, one
clustering step's loss and gradients and the benchmark with weights
carried across, the rate schedule and the set sizes, the max-regression
models' forward, and the training thresholds tests/test_tasks.py holds the
JAX tasks to.  Inputs come from numpy seeds; the JAX weights cross through
the checkpoint mappings."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pcaudio.tasks.clustering as jax_clustering
from pcaudio.checkpoint.torch_import import (
    _dense, deepset_params, pma_params, sab_params, set_transformer_params)
from pcaudio.data import modelnet40 as jax_mn40
from pcaudio.tasks.max_regression import (
    SmallDeepSet as JaxSmallDeepSet, SmallSetTransformer as JaxSmallST)
from pcaudio.utils.metrics import read_metrics as jax_read_metrics
from pcaudio_torch import cli
from pcaudio_torch.checkpoint import (
    deepset_state_dict_from_jax, set_transformer_state_dict_from_jax,
    small_deepset_state_dict_from_jax, small_set_transformer_state_dict_from_jax)
from pcaudio_torch.data import modelnet40 as mn40
from pcaudio_torch.eval import plots
from pcaudio_torch.tasks import clustering
from pcaudio_torch.tasks.max_regression import (
    SmallDeepSet, SmallSetTransformer, train as train_max)
from pcaudio_torch.tasks.modelnet40 import ModelNet40Config, train as train_mn40

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: pytest-xdist runs several workers side by
    side, and their default thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mn40_h5(tmp_path_factory):
    """tests/test_tasks.py's synthetic ModelNet40 dump: two classes told
    apart by per-axis scale ratios (which standardization keeps), 40 train
    and 20 test clouds of 200 points."""
    import h5py

    rng = np.random.default_rng(0)
    p = str(tmp_path_factory.mktemp("mn40") / "mn40.h5")
    ntr, nte, npts = 40, 20, 200
    lab_tr = rng.integers(0, 2, ntr)
    lab_te = rng.integers(0, 2, nte)

    def clouds_for(labels):
        x = rng.standard_normal((len(labels), npts, 3))
        scl = np.stack([np.ones(len(labels)), 1.0 + 3.0 * labels,
                        1.0 / (1.0 + 2.0 * labels)], axis=-1)
        return x * scl[:, None, :]

    with h5py.File(p, "w") as f:
        f["tr_cloud"], f["tr_labels"] = clouds_for(lab_tr), lab_tr
        f["test_cloud"], f["test_labels"] = clouds_for(lab_te), lab_te
    return p


# ---- data/modelnet40 -------------------------------------------------------

@pytest.mark.parametrize("split,augment", [("train", False), ("train", True),
                                           ("test", False)])
def test_fetcher_batches_equal_jax(mn40_h5, split, augment):
    """Two epochs of batches equal the JAX fetcher's exactly (the fixed
    permutation, the shuffles, the augmentation draws, the dropped final
    batch, the test stride), from the h5 and from the same arrays in
    memory."""
    kw = dict(batch_size=8, down_sample=4, do_augmentation=augment, seed=3)
    ref = jax_mn40.ModelNet40Fetcher(mn40_h5, **kw)
    got = mn40.ModelNet40Fetcher(mn40_h5, **kw)
    mem = mn40.ModelNet40Fetcher.from_arrays(
        ref.train_clouds, ref.train_labels, ref.test_clouds, ref.test_labels,
        **kw)
    np.testing.assert_array_equal(got.perm, ref.perm)
    assert got.num_classes == ref.num_classes == 2
    for _ in range(2):
        batches = [list(getattr(f, f"{split}_data")()) for f in (ref, got, mem)]
        assert len(batches[0]) == (4 if split == "train" else 2)
        for b_ref, b_got, b_mem in zip(*batches):
            for a, b, c in zip(b_ref, b_got, b_mem):
                assert a.dtype == b.dtype == c.dtype
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)


def test_standardize_rotate_augment_equal_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 64, 3)).astype(np.float32)
    x[0, 5, 1] = 1e4  # clipped at 100 × mean |x|
    np.testing.assert_array_equal(mn40.standardize(x), jax_mn40.standardize(x))
    theta = rng.uniform(-1, 1, 3)
    np.testing.assert_array_equal(mn40.rotate_z(theta, x),
                                  jax_mn40.rotate_z(theta, x))
    np.testing.assert_array_equal(
        mn40.augment(x, np.random.default_rng(2)),
        jax_mn40.augment(x, np.random.default_rng(2)))


# ---- clustering --------------------------------------------------------------

def _mixtures(seed, B=3, N=40, K=4, dim=2):
    """Numpy mixtures: points, π, μ, σ."""
    rng = np.random.default_rng(seed)
    pi = rng.dirichlet(np.ones(K), B).astype(np.float32)
    mu = rng.uniform(-4, 4, (B, K, dim)).astype(np.float32)
    sigma = rng.uniform(0.2, 1.0, (B, K, dim)).astype(np.float32)
    X = rng.uniform(-5, 5, (B, N, dim)).astype(np.float32)
    return X, pi, mu, sigma


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_mog_functions_match_jax():
    X, pi, mu, sigma = _mixtures(0)
    np.testing.assert_allclose(
        clustering.diag_mvn_log_prob(*_t(X, mu, sigma)).numpy(),
        np.asarray(jax_clustering.diag_mvn_log_prob(X, mu, sigma)), **TOL)
    ll, lab = clustering.mog_log_likelihood(*_t(X, pi, mu, sigma),
                                            return_labels=True)
    rll, rlab = jax_clustering.mog_log_likelihood(X, pi, mu, sigma,
                                                  return_labels=True)
    np.testing.assert_allclose(ll.item(), float(rll), **TOL)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(rlab))
    raw = np.random.default_rng(1).standard_normal((3, 4, 5)).astype(np.float32)
    for got, ref in zip(clustering.parse_raw(torch.from_numpy(raw), 2),
                        jax_clustering.parse_raw(raw, 2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def carried():
    """For each clustering model: the JAX model of the JAX ``build`` (its
    init traced abstractly, for the parameter shapes), the port's model
    from its own ``build`` (ε set to flax's 1e-6 for the LayerNorms of the
    ST), and the port's weights as flax params (the JAX package's
    importer), which must have the JAX init's shapes."""
    out = {}
    for name, to_jax, to_sd in (
            ("set_transformer", set_transformer_params,
             set_transformer_state_dict_from_jax),
            ("deepset", deepset_params, deepset_state_dict_from_jax)):
        cfg = clustering.ClusteringConfig(model=name, K=3, N_max=30, B=4)
        box = {}

        def init():
            box["model"], _, params = jax_clustering.build(cfg)
            return params

        shapes = jax.eval_shape(init)
        tm, _, _ = clustering.build(cfg, "cpu")
        params = to_jax({k: v.numpy() for k, v in tm.state_dict().items()})
        assert (jax.tree_util.tree_map(np.shape, params)
                == jax.tree_util.tree_map(lambda a: a.shape, shapes))
        for m in tm.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.eps = 1e-6
        out[name] = cfg, box["model"], params, tm, to_sd
    return out


@pytest.mark.parametrize("name", ["set_transformer", "deepset"])
def test_clustering_step_loss_and_grads_match_jax(carried, name):
    """One batch's negative log-likelihood and every parameter gradient,
    the weights carried across: within 1e-5 of the gradient vector's
    largest entry."""
    cfg, jm, params, tm, to_sd = carried[name]
    X = np.random.default_rng(2).uniform(-5, 5, (cfg.B, 25, 2)).astype(np.float32)

    def loss(p):
        pi, mu, sigma = jax_clustering.parse_raw(jm.apply(p, X), cfg.dim)
        return -jax_clustering.mog_log_likelihood(X, pi, mu, sigma)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss))(params)
    ref_grads = to_sd(jax.tree_util.tree_map(np.asarray, ref_grads))
    tm.zero_grad()
    got = clustering._loss(tm, torch.from_numpy(X), cfg.dim)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref_loss), rtol=1e-5)
    scale = max(float(np.abs(g.numpy()).max()) for g in ref_grads.values())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[n].numpy(),
                                   atol=1e-5 * scale, rtol=0, err_msg=n)


def test_benchmark_matches_jax(carried, monkeypatch):
    """Both packages' ``benchmark`` over the same numpy mixtures (each
    package's ``sample_mog`` replaced by them): model and oracle
    log-likelihoods within 1e-5."""
    cfg, jm, params, tm, _ = carried["set_transformer"]
    draws = [_mixtures(s, cfg.B, cfg.N_max, cfg.K) for s in (3, 4)]

    def feeder(convert):
        it = iter(draws)

        def sample_mog(*args):
            X, pi, mu, sigma = map(convert, next(it))
            return X, None, pi, (mu, sigma)
        return sample_mog

    monkeypatch.setattr(jax_clustering, "sample_mog", feeder(jnp.asarray))
    ref = jax_clustering.benchmark(jm, params, cfg, num_batches=2)
    monkeypatch.setattr(clustering, "sample_mog", feeder(torch.from_numpy))
    got = clustering.benchmark(tm, cfg, num_batches=2)
    np.testing.assert_allclose(got, ref, **TOL)


def test_schedule_and_set_sizes_match_jax(monkeypatch):
    """The rate of every update: ×0.1 from update ``num_steps // 2`` on in
    both packages, the rates equal but for the f32 rounding of optax's
    product;
    ``train`` draws the JAX sequence of set sizes N exactly."""
    cfg = clustering.ClusteringConfig(model="deepset", K=2, B=2, N_min=5,
                                      N_max=40, num_steps=10)
    optax = jax_clustering.optax
    adam, scheds = optax.adam, []
    monkeypatch.setattr(optax, "adam", lambda s: scheds.append(s) or adam(s))
    jax.eval_shape(lambda: jax_clustering.build(cfg)[2])  # init traced only
    _, optimizer, scheduler = clustering.build(cfg, "cpu")
    rates = []
    for _ in range(cfg.num_steps):
        rates.append(optimizer.param_groups[0]["lr"])
        optimizer.step()
        scheduler.step()
    half = cfg.num_steps // 2
    assert rates[half - 1] == cfg.lr and rates[half] == cfg.lr * 0.1
    ref = [float(scheds[0](t)) for t in range(cfg.num_steps)]
    assert [r < cfg.lr for r in rates] == [r < ref[0] for r in ref]
    assert np.float32(rates[half - 1]) == np.float32(ref[half - 1])
    # optax multiplies in f32: f32(1e-3) · f32(0.1) = 1.00000005e-4, one
    # f32 ulp from f32(1e-4)
    np.testing.assert_allclose(rates, ref, rtol=2.0 ** -23, atol=0)

    sizes = {"jax": [], "port": []}

    def recorder(tag, fn):
        def sample_mog(key, B, N, K, dim):
            sizes[tag].append(N)
            return fn(key, B, N, K, dim)
        return sample_mog

    monkeypatch.setattr(jax_clustering, "sample_mog", recorder(
        "jax", lambda k, B, N, K, d: (jnp.zeros((B, N, d)), None, None, None)))
    monkeypatch.setattr(jax_clustering, "build",
                        lambda c: (None, adam(1e-3), {}))
    monkeypatch.setattr(jax_clustering, "make_train_step",
                        lambda *a: lambda s, X, r: (s, jnp.zeros(())))
    jax_clustering.train(cfg, num_steps=8, seed=5, log=lambda s: None)
    monkeypatch.setattr(clustering, "sample_mog",
                        recorder("port", clustering.sample_mog))
    _, state, losses = clustering.train(cfg, num_steps=8, seed=5,
                                        log=lambda s: None, device="cpu")
    assert state.step == 8 and losses.shape == (8,) and losses.isfinite().all()
    assert sizes["port"] == sizes["jax"] and len(set(sizes["jax"])) > 1


def test_sample_mog_by_distribution():
    """π sums to 1 with Dirichlet(1)'s mean 1/K, label frequencies follow
    π, μ in [-4, 4], points 0.3 from their component's mean; the same seed
    gives the same draws."""
    g = torch.Generator().manual_seed(0)
    B, N, K = 500, 2000, 3
    X, labels, pi, (mu, sigma) = clustering.sample_mog(g, B, N, K)
    assert X.shape == (B, N, 2) and labels.shape == (B, N) and pi.shape == (B, K)
    np.testing.assert_allclose(pi.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert abs(pi.mean().item() - 1 / K) < 0.02
    assert (pi[:, 0] < 0.1).float().mean().item() == pytest.approx(
        1 - 0.9 ** (K - 1), abs=0.05)  # Beta(1, K-1)'s CDF at 0.1
    freq = torch.nn.functional.one_hot(labels, K).float().mean(1)
    sd = torch.sqrt(pi * (1 - pi) / N)
    assert bool(((freq - pi).abs() <= 5 * sd + 1e-6).all())
    assert float(mu.min()) >= -4 and float(mu.max()) <= 4
    assert bool((sigma == 0.3).all())
    resid = X - torch.gather(mu, 1, labels[..., None].expand(B, N, 2))
    assert resid.std().item() == pytest.approx(0.3, rel=0.01)
    again = clustering.sample_mog(torch.Generator().manual_seed(0), B, N, K)
    assert torch.equal(again[0], X) and torch.equal(again[1], labels)


# ---- max regression ----------------------------------------------------------

def _small_st_params(sd):
    """The port's SmallSetTransformer weights as flax params, through the
    JAX package's importer pieces."""
    return {"params": {"sab0": sab_params(sd, "sab0"),
                       "sab1": sab_params(sd, "sab1"),
                       "pma": pma_params(sd, "pma"), "out": _dense(sd, "out")}}


def _small_deepset_params(sd):
    return {"params": {f"Dense_{i}": _dense(sd, name) for i, name in
                       enumerate(("enc.0", "enc.2", "dec.0", "dec.2"))}}


@pytest.mark.parametrize("pool", [None, "max", "mean", "sum"])
def test_max_regression_models_match_jax(pool):
    """The small ST (on a ragged mask) and the DeepSet with each pool: the
    port's weights as flax params have the JAX init's tree and shapes, come
    back unchanged through the port's mapping, and give the JAX forward
    within 1e-5."""
    x = 2.0 * np.random.default_rng(4).standard_normal((5, 7, 1)).astype(np.float32)
    torch.manual_seed(0)
    if pool is None:
        jm, tm = JaxSmallST(dim_hidden=16, num_heads=2), SmallSetTransformer(16, 2)
        to_jax, to_sd = _small_st_params, small_set_transformer_state_dict_from_jax
        mask = np.arange(7)[None, :] < np.array([7, 5, 3, 1, 7])[:, None]
        inputs = (x, mask)
    else:
        jm, tm = JaxSmallDeepSet(pool=pool, dim_hidden=16), SmallDeepSet(pool, 16)
        to_jax, to_sd = _small_deepset_params, small_deepset_state_dict_from_jax
        inputs = (x,)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = to_jax(sd)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 7, 1)))
    assert (jax.tree_util.tree_map(np.shape, params)
            == jax.tree_util.tree_map(lambda a: a.shape, shapes))
    back = to_sd(params)
    assert sorted(back) == sorted(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    ref = np.asarray(jax.jit(jm.apply)(params, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, inputs))
    assert got.shape == ref.shape == (5,)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


# ---- the thresholds tests/test_tasks.py holds the JAX tasks to ---------------

def test_modelnet40_training_improves(mn40_h5):
    cfg = ModelNet40Config(num_pts=50, dim=32, n_heads=4, n_anc=4,
                           batch_size=8, dim_output=2, learning_rate=3e-3)
    state, hist = train_mn40(cfg, mn40_h5, epochs=20, eval_every=1,
                             log=lambda s: None, device="cpu")
    assert state.step == 80 and state.generator is not None
    assert min(h["train_loss"] for h in hist[-6:]) < hist[0]["train_loss"]
    assert np.mean([h["test_accuracy"] for h in hist[-3:]]) > 0.55


def test_clustering_trains_toward_oracle():
    cfg = clustering.ClusteringConfig(K=2, B=8, N_min=50, N_max=80,
                                      num_steps=200)
    model, optimizer, scheduler = clustering.build(cfg, "cpu")
    step = clustering.make_train_step(model, optimizer, scheduler, cfg)
    g = torch.Generator().manual_seed(0)
    losses = [float(step(clustering.sample_mog(g, cfg.B, 64, cfg.K)[0]))
              for _ in range(120)]
    assert losses[-1] < losses[0]
    mll, oll = clustering.benchmark(model, cfg, num_batches=3)
    assert np.isfinite(mll) and np.isfinite(oll) and oll >= mll - 1.0


def test_max_regression_models_train():
    torch.manual_seed(0)
    _, st_mae = train_max(SmallSetTransformer(dim_hidden=16, num_heads=2),
                          steps=150, device="cpu")
    _, ds_mae = train_max(SmallDeepSet(pool="max", dim_hidden=16), steps=150,
                          device="cpu")
    assert st_mae < 1.0 and ds_mae < 1.0


# ---- the MoG figures and the three commands ----------------------------------

def test_plot_clustering_batch_draws_the_model_fit(tmp_path):
    """The JAX figure's points and ellipses from the port's tensors."""
    import matplotlib
    import pcaudio.eval.plots as jax_plots

    matplotlib.use("Agg")
    g = torch.Generator().manual_seed(1)
    X, labels, pi, (mu, sigma) = clustering.sample_mog(g, 3, 50, 3)
    out = str(tmp_path / "mog.png")
    fig = plots.plot_clustering_batch(X, labels, mu, sigma, out_path=out)
    ref = jax_plots.plot_clustering_batch(X.numpy(), labels.numpy(),
                                          mu.numpy(), sigma.numpy())
    assert os.path.getsize(out) > 1000
    for a, b in zip(fig.axes, ref.axes):
        assert len(a.patches) == len(b.patches)
        for p, q in zip(a.patches, b.patches):
            np.testing.assert_allclose(p.get_center(), q.get_center())
            assert (p.width, p.height, p.angle) == pytest.approx(
                (q.width, q.height, q.angle))
        for c, d in zip(a.collections, b.collections):
            np.testing.assert_array_equal(c.get_offsets(), d.get_offsets())
    assert len(fig.axes) == 4 and not fig.axes[3].axison


def test_cli_task_commands_run_on_the_cpu(mn40_h5, tmp_path, capsys):
    """``modelnet40`` writes its JSONL log, which both packages read;
    ``clustering`` and ``max-regression`` print their JSON lines."""
    log_dir = str(tmp_path / "result")
    state, hist = cli.main([
        "modelnet40", "--data", mn40_h5, "--num_pts", "50", "--dim", "16",
        "--n_heads", "2", "--n_anc", "4", "--batch_size", "8",
        "--train_epochs", "2", "--log-dir", log_dir, "--device", "cpu"])
    path = os.path.join(log_dir, "N50_d16h2i4_lr0.001bs8.jsonl")
    recs = jax_read_metrics(path)
    assert [r["epoch"] for r in recs] == [0, 1] and recs[0]["index"] == 0
    assert list(recs[0])[:2] == ["index", "time"] and "test_accuracy" in recs[0]
    assert recs[1]["train_loss"] == hist[1]["train_loss"]

    out = cli.main(["clustering", "--mode", "bench", "--num_steps", "3",
                    "--K", "2", "--B", "2", "--device", "cpu"])
    assert set(out) == {"model_ll", "oracle_ll"}
    assert all(np.isfinite(v) for v in out.values())
    out = cli.main(["max-regression", "--steps", "20", "--device", "cpu"])
    assert set(out) == {"set_transformer", "deepset_max", "deepset_mean"}
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed[-1] == out and set(printed[-2]) == {"model_ll", "oracle_ll"}


def test_task_commands_need_cuda_unless_told_cpu(mn40_h5):
    if torch.cuda.is_available():
        pytest.skip("this checks the message on a machine without CUDA")
    for argv in (["modelnet40", "--data", mn40_h5], ["clustering"],
                 ["max-regression"]):
        with pytest.raises(SystemExit, match="--device cpu"):
            cli.main(argv)
