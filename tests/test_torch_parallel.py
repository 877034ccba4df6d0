"""pcaudio_torch.parallel against the JAX package's mesh code, on the CPU.

Two ``gloo`` worlds of worker processes (``tests/torch_parallel_worker.py``,
which imports only torch and pcaudio_torch) run once for the module: four
ranks for the set-sharded ST at meshes (1, 4), (2, 2) and (4, 1) (logits,
the collective schedule, gradients, the serving pipeline, a DP step and
``fit`` with the set axis, the mesh helpers), and two ranks on ``data`` (an
SGD and an Adam step through DDP, ``fit`` with checkpoints and resume, and
``fit`` refusing a step whose sharding differs from what it was asked for).
The JAX side runs here, on conftest's 8-device CPU mesh; the weights cross
with ``st_state_dict_from_jax``.  Bars: logits 1e-4 of JAX
(docs/ACCURACY.md's f32 bar) and 1e-5 of the port's own unsharded ST;
gradients atol 1e-5, rtol 1e-4 (tests/test_set_sharded.py); DP losses rtol
1e-5 and parameters atol 1e-5 (tests/test_train.py).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pcaudio.eval.pipeline import TemporalPipelineConfig as JaxPipelineConfig
from pcaudio.eval.pipeline import extract_chunk_clouds as jax_extract_chunk_clouds
from pcaudio.nn import ST as JaxST
from pcaudio.parallel import make_mesh as jax_make_mesh
from pcaudio.parallel import shard_batch as jax_shard_batch
from pcaudio.parallel.set_sharded import set_sharded_st_forward as jax_set_sharded
from pcaudio.train import TrainState as JaxTrainState
from pcaudio.train import jit_train_step
from pcaudio.train import make_train_step as jax_make_train_step
from pcaudio.train import pointcloud_apply as jax_pointcloud_apply
from pcaudio_torch.checkpoint import st_state_dict_from_jax
from pcaudio_torch.nn import ST
from pcaudio_torch.train import TrainState, fit, make_eval_step, make_train_step, pointcloud_apply
from torch_parallel_worker import ARCH, MESHES, SGD_LR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")

LOGIT_TOL, SELF_TOL = 1e-4, 1e-5
SHARDED_MAB = ["all_reduce:MAX@set", "all_reduce:SUM@set", "all_reduce:SUM@set"]


def _synthetic_sets(rng, n, k):
    """tests/test_train.py's two separable classes (clouds at +1 and -1)."""
    labels = rng.integers(0, 2, n)
    centers = np.where(labels[:, None, None] == 1, 1.0, -1.0)
    points = centers + 0.1 * rng.standard_normal((n, k, 2))
    return points.astype(np.float32), labels.astype(np.int32)


def _jax_sharded(params, points, mask, mesh):
    """The JAX sharded forward, jitted (op by op, shard_map is slow)."""
    return jax.jit(lambda p, x, m: jax_set_sharded(p, x, m, mesh, num_heads=4))(
        params, points, mask)


def _jax_params(key):
    a = ARCH[key]
    model = JaxST(dim_input=a["dim_input"], num_outputs=1, dim_output=a["dim_output"],
                  num_inds=a["num_inds"], dim_hidden=a["dim_hidden"],
                  num_heads=a["num_heads"])
    return model, model.init(jax.random.key(0), jnp.zeros((1, 8, a["dim_input"])))


def _port_st(key, params):
    model = ST(**ARCH[key])
    model.load_state_dict(st_state_dict_from_jax(params))
    return model


def _inputs():
    rng = np.random.default_rng(0)
    B, N = 4, 64
    pts = rng.standard_normal((B, N, 3)).astype(np.float32)
    counts = np.array([N, N - 9, N // 2, 5])        # 5: whole set shards masked
    inputs = {"pts": pts, "mask": np.arange(N)[None, :] < counts[:, None]}
    rng = np.random.default_rng(1)
    inputs["g_pts"] = rng.standard_normal((2, 32, 2)).astype(np.float32)
    inputs["g_labels"] = rng.integers(0, 10, 2).astype(np.int32)
    inputs["g_mask"] = np.arange(32)[None, :] < np.array([32, 5])[:, None]
    inputs["waves"] = (0.1 * np.random.default_rng(2).standard_normal((2, 16384))
                       ).astype(np.float32)
    inputs["dp_pts"], inputs["dp_labels"] = _synthetic_sets(
        np.random.default_rng(3), 16, 32)
    inputs["fit_pts"], inputs["fit_labels"] = _synthetic_sets(
        np.random.default_rng(4), 32, 16)
    params = {}
    for key in ARCH:
        _, params[key] = _jax_params(key)
        inputs.update({f"{key}/{k}": v.numpy()
                       for k, v in st_state_dict_from_jax(params[key]).items()})
    return inputs, params


def _run_world(work, world, size):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, WORKER, world, str(r), str(size), str(work)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, text=True) for r in range(size)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of world {world!r} failed:\n{out}"
    return [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(size)]


@pytest.fixture(scope="module")
def data():
    return _inputs()


@pytest.fixture(scope="module")
def set_world(data, tmp_path_factory):
    work = tmp_path_factory.mktemp("set_world")
    np.savez(work / "inputs.npz", **data[0])
    return _run_world(work, "set", 4)


@pytest.fixture(scope="module")
def dp_world(data, tmp_path_factory):
    work = tmp_path_factory.mktemp("dp_world")
    np.savez(work / "inputs.npz", **data[0])
    return _run_world(work, "dp", 2)


def _rows(rank, n_data, n_set, B):
    """The global rows of a rank's data shard."""
    per = B // n_data
    d = rank // n_set
    return slice(d * per, (d + 1) * per)


def _close(got, ref, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("n_data,n_set", MESHES)
def test_set_sharded_logits_match_jax(set_world, data, n_data, n_set):
    """Each rank's logits equal its data shard's rows of the JAX sharded
    forward (and of the unsharded port ST); (1, 4) and (2, 2) include
    samples whose valid points end inside the first set shard."""
    inputs, params = data
    mesh = jax_make_mesh(n_data=n_data, n_set=n_set)
    ref = np.asarray(_jax_sharded(params["w32"], inputs["pts"], inputs["mask"], mesh))
    with torch.no_grad():
        own = _port_st("w32", params["w32"])(
            torch.from_numpy(inputs["pts"]), torch.from_numpy(inputs["mask"])).numpy()
    for r, out in enumerate(set_world):
        rows = _rows(r, n_data, n_set, 4)
        got = out[f"fwd/{n_data}x{n_set}"]
        _close(got, ref[rows], LOGIT_TOL, what=f"rank {r} vs JAX")
        _close(got, own[rows], SELF_TOL, what=f"rank {r} vs the unsharded port ST")


@pytest.mark.parametrize("n_data,n_set", MESHES)
def test_set_sharded_collective_schedule(set_world, n_data, n_set):
    """A forward issues exactly one MAX and two SUM all-reduces over the set
    group per sharded-keys MAB (MAB0 twice, PMA): 3 MAX + 6 SUM and no
    other collective; its backward one SUM each."""
    for r, out in enumerate(set_world):
        fwd, bwd = json.loads(str(out[f"calls/{n_data}x{n_set}"]))
        assert fwd == SHARDED_MAB * 3, (r, fwd)
        assert bwd == ["all_reduce:SUM@set"] * 3, (r, bwd)


@pytest.mark.parametrize("n_data,n_set", MESHES)
def test_mesh_coordinates_and_local_batch_slice(set_world, n_data, n_set):
    """Rank r sits at (r // n_set, r % n_set), as JAX reshapes its devices;
    local_batch_slice cuts by the data coordinate, so a set group's ranks
    get the same rows."""
    for r, out in enumerate(set_world):
        assert out[f"coords/{n_data}x{n_set}"].tolist() == [r // n_set, r % n_set]
        rows = _rows(r, n_data, n_set, 8)
        assert out[f"slice/{n_data}x{n_set}"].tolist() == [rows.start, rows.stop]


def test_set_sharded_grads_match_jax_grad(set_world, data):
    """The ranks' parameter gradients through the sharded forward at (1, 4),
    averaged over the world (DDP's rule), equal jax.grad through the JAX
    sharded forward; one sample's valid points end in the first shard."""
    inputs, params = data
    mesh = jax_make_mesh(n_data=1, n_set=4)
    labels = jnp.asarray(inputs["g_labels"])

    @jax.jit
    def loss(p):
        lg = jax_set_sharded(p, inputs["g_pts"], inputs["g_mask"], mesh, num_heads=4)
        return optax.softmax_cross_entropy_with_integer_labels(lg, labels).mean()

    ref = st_state_dict_from_jax(jax.jit(jax.grad(loss))(params["w16"]))
    assert set(ref) == {k[len("grad/"):] for k in set_world[0] if k.startswith("grad/")}
    for r, out in enumerate(set_world):
        for name, g in ref.items():
            _close(out[f"grad/{name}"], g.numpy(), 1e-5, 1e-4, f"rank {r} d{name}")
        _close(out["g_loss"], float(loss(params["w16"])), 0, 1e-5, "loss")


def test_set_sharded_serving_pipeline(set_world, data):
    """The port's chunk clouds through the set-sharded ST at (2, 2) equal
    JAX's clouds through its sharded forward (tests/test_set_sharded.py:
    65-94)."""
    inputs, params = data
    waves = jnp.asarray(inputs["waves"])
    cfg = JaxPipelineConfig(fs=44100, n_fft=1024, num_frames=10, top_k=64,
                            extraction="exact")
    cloud, _ = jax.jit(lambda w, n: jax_extract_chunk_clouds(w, n, cfg))(
        waves, jnp.full((2,), waves.shape[1], jnp.int32))
    ref = np.asarray(_jax_sharded(params["w32"], cloud.points, cloud.mask,
                                  jax_make_mesh(n_data=2, n_set=2)))
    for r, out in enumerate(set_world):
        _close(out["pipe"], ref[_rows(r, 2, 2, ref.shape[0])], LOGIT_TOL, what=f"rank {r}")


def _jax_dp_step(params, batch, mesh, shard_set_axis=False):
    model, _ = _jax_params("w8")
    opt = optax.sgd(SGD_LR)
    step = jax_make_train_step(jax_pointcloud_apply(model), opt)
    state, m = jit_train_step(step, mesh=mesh, donate_state=False)(
        JaxTrainState.create(params, opt),
        jax_shard_batch(mesh, batch, shard_set_axis=shard_set_axis), jax.random.key(0))
    return float(m["loss"]), st_state_dict_from_jax(state.params)


def _jax_grads(params, batch):
    model, _ = _jax_params("w8")

    def loss(p):
        lg = model.apply(p, batch["points"])
        return optax.softmax_cross_entropy_with_integer_labels(lg, batch["labels"]).mean()

    return st_state_dict_from_jax(jax.jit(jax.grad(loss))(params))


def test_dp_step_with_the_set_axis_matches_jax(set_world, data):
    """One SGD step through DDP over the set-sharded forward at (2, 2)
    equals JAX's jit_train_step over its (2, 2) mesh with the point axis
    sharded: the loss averaged over the data ranks, every rank's gradients
    and parameters."""
    inputs, params = data
    batch = {"points": inputs["dp_pts"], "labels": inputs["dp_labels"]}
    loss, ref = _jax_dp_step(params["w8"], batch, jax_make_mesh(n_data=2, n_set=2), True)
    grads = _jax_grads(params["w8"], {k: jnp.asarray(v) for k, v in batch.items()})
    local = [out["dp_loss"] for out in set_world]
    _close(np.mean([local[0], local[2]]), loss, 0, 1e-5, "loss")
    for r, out in enumerate(set_world):
        assert local[r] == local[r ^ 1], "a set group's ranks differ in loss"
        for name, p in ref.items():
            _close(out[f"dp_params/{name}"], p.numpy(), 1e-5, what=f"rank {r} {name}")
            _close(out[f"dp_grad/{name}"], grads[name].numpy(), 1e-5, 1e-4,
                   f"rank {r} d{name}")


def _single_fit(params, inputs, epochs):
    """fit in one process, the same data, batches, SGD and evals."""
    model = _port_st("w8", params)
    opt = torch.optim.SGD(model.parameters(), lr=SGD_LR)
    data = {"points": inputs["fit_pts"], "labels": inputs["fit_labels"]}
    _, hist = fit(TrainState(model, opt), make_train_step(pointcloud_apply(model), opt),
                  data, batch_size=8, epochs=epochs, seed=0, eval_data=data,
                  eval_step=make_eval_step(pointcloud_apply(model)), eval_every=1,
                  log=lambda _: None)
    return hist, model


def test_fit_with_the_set_axis_matches_single_process(set_world, data):
    """fit over (2, 2) with shard_set_axis: the same epoch losses and eval
    accuracies as fit in one process."""
    hist, _ = _single_fit(data[1]["w8"], data[0], 2)
    for r, out in enumerate(set_world):
        _close(out["fit_loss"], [h["train_loss"] for h in hist], 0, 1e-5, f"rank {r}")
        _close(out["fit_acc"], [h["test_accuracy"] for h in hist], 0, 0, f"rank {r}")


def test_shard_batch_refuses_axes_that_do_not_divide(set_world):
    """3 clouds over 2 data ranks, 9 points over 2 set ranks: JAX's
    NamedSharding does not pad, and neither does shard_batch."""
    for out in set_world:
        assert out["refused/(3, 8, 2)"] and out["refused/(4, 9, 2)"]


def test_initialize_distributed_is_idempotent(set_world):
    """A second call with the backend that is up returns; one naming
    another backend raises rather than keep the first quietly."""
    for out in set_world:
        assert out["other_backend_raised"]


def test_global_mesh_and_global_batch_array(set_world, data):
    for r, out in enumerate(set_world):
        assert out["global_mesh"].tolist() == [2, 2, r // 2, r % 2]
        rows = _rows(r, 2, 2, 8)
        np.testing.assert_array_equal(out["global_batch"], data[0]["dp_labels"][rows])


def test_dp_step_sgd_matches_jax(dp_world, data):
    """Two ranks on data, one SGD step through DDP: JAX's jit_train_step
    over make_mesh(n_data=2) (the global loss, every parameter)."""
    inputs, params = data
    batch = {"points": inputs["dp_pts"], "labels": inputs["dp_labels"]}
    loss, ref = _jax_dp_step(params["w8"], batch, jax_make_mesh(n_data=2))
    for r, out in enumerate(dp_world):
        _close(out["sgd_loss"], loss, 0, 1e-5, f"rank {r} loss")
        for name, p in ref.items():
            _close(out[f"sgd_params/{name}"], p.numpy(), 1e-5, what=f"rank {r} {name}")


def test_dp_step_adam_grads_match_jax(dp_world, data):
    """With the recipes' torch Adam(weight_decay): the gradients DDP
    averaged equal jax.grad of the global batch's mean loss, and the ranks
    end the step bit-identical."""
    inputs, params = data
    grads = _jax_grads(params["w8"], {"points": jnp.asarray(inputs["dp_pts"]),
                                      "labels": jnp.asarray(inputs["dp_labels"])})
    for r, out in enumerate(dp_world):
        for name, g in grads.items():
            _close(out[f"adam_grad/{name}"], g.numpy(), 1e-5, 1e-4, f"rank {r} d{name}")
    for name in grads:
        np.testing.assert_array_equal(dp_world[0][f"adam_params/{name}"],
                                      dp_world[1][f"adam_params/{name}"])


def test_replicated_broadcasts_rank_0(dp_world, data):
    """Rank 1 starts from other weights; replicated() gives it rank 0's."""
    for r, out in enumerate(dp_world):
        assert out["sgd_replicated_ok"] and out["adam_replicated_ok"], r


def test_fit_over_the_mesh_matches_single_process(dp_world, data):
    """Two ranks: epochs 0-1, then epoch 2 resumed from the checkpoint,
    equal three epochs of fit in one process (losses, eval accuracies,
    the final parameters)."""
    hist, model = _single_fit(data[1]["w8"], data[0], 3)
    for r, out in enumerate(dp_world):
        assert out["fit_epochs"].tolist() == [0, 1, 2]
        _close(out["fit_loss"], [h["train_loss"] for h in hist], 0, 1e-5, f"rank {r}")
        _close(out["fit_acc"], [h["test_accuracy"] for h in hist], 0, 0, f"rank {r}")
        for name, p in model.named_parameters():
            _close(out[f"fit_params/{name}"], p.detach().numpy(), 1e-5, what=f"rank {r} {name}")


def test_fit_over_the_mesh_checkpoints_on_rank_0_only(dp_world):
    assert dp_world[0]["fit_saves"].tolist() == [1, 2, 3]
    assert dp_world[1]["fit_saves"].tolist() == []


@pytest.mark.parametrize("case", ["set_axis_not_wrapped", "set_axis_wrapped_not_asked",
                                  "not_wrapped"])
def test_fit_refuses_a_step_sharded_another_way(dp_world, case):
    """data_parallel decides whether the point axis is sharded: fit over a
    mesh raises where its shard_set_axis differs from that call's, or where
    data_parallel never wrapped the model (the ranks would otherwise run the
    plain ST on parts of each cloud, or not average their gradients)."""
    for r, out in enumerate(dp_world):
        assert out[f"refused/{case}"], (r, case)
