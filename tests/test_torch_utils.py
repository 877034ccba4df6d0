"""The port's utilities (pcaudio_torch.utils) against the JAX package's on
the CPU: parameter totals of every model the two packages share, the JSONL
metrics stream read across packages, the non-finite-leaf message, NaN
debugging, the purity check, the timer and the trace."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pcaudio.tasks.clustering as jax_clustering
import pcaudio.tasks.modelnet40 as jax_mn40_task
from pcaudio.tasks.max_regression import (
    SmallDeepSet as JaxSmallDeepSet, SmallSetTransformer as JaxSmallST)
from pcaudio.train import recipes as jax_recipes
from pcaudio.utils import (
    MetricsWriter as JaxMetricsWriter, assert_finite_tree as jax_assert_finite_tree,
    count_parameters as jax_count_parameters, read_metrics as jax_read_metrics)
from pcaudio_torch.tasks import clustering, modelnet40
from pcaudio_torch.tasks.max_regression import SmallDeepSet, SmallSetTransformer
from pcaudio_torch.train import RECIPES
from pcaudio_torch.utils import (
    MetricsWriter, assert_finite_tree, check_jit_purity, count_parameters,
    device_sync, enable_nan_debugging, named_parameters, read_metrics,
    time_fn, trace)
from pcaudio_torch.utils.profiling import count, count_device, span


def _jax_build_params(build, cfg):
    """The params tree of a JAX task ``build``, its init traced
    abstractly (shapes only)."""
    return jax.eval_shape(lambda: build(cfg)[2])


def _recipe(name):
    shapes = {"FST": (1, 8, 2), "3ST": (1, 8, 3), "FB": (1, 1025),
              "CNNTemp": (1, 10, 512)}[name]
    jm = jax_recipes.RECIPES[name]().build_model()
    return (jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros(shapes)),
            RECIPES[name]().build_model())


def _task(name):
    if name == "modelnet40":
        cfg = modelnet40.ModelNet40Config()
        return (_jax_build_params(jax_mn40_task.build, cfg),
                modelnet40.build(cfg, "cpu")[0])
    if name.startswith("clustering"):
        cfg = clustering.ClusteringConfig(model=name.split("_", 1)[1])
        return (_jax_build_params(jax_clustering.build, cfg),
                clustering.build(cfg, "cpu")[0])
    jm, tm = ((JaxSmallST(), SmallSetTransformer()) if name == "small_st"
              else (JaxSmallDeepSet(), SmallDeepSet()))
    return jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 10, 1))), tm


@pytest.mark.parametrize("name", ["FST", "3ST", "FB", "CNNTemp", "modelnet40",
                                  "clustering_set_transformer",
                                  "clustering_deepset", "small_st",
                                  "small_deepset"])
def test_count_parameters_equals_jax(name, capsys):
    """The trainable-parameter total of each model of the recipes and the
    tasks equals the JAX function's on the flax params, and both print the
    same total line."""
    params, model = (_recipe if name in RECIPES else _task)(name)
    ref = jax_count_parameters(params, display=True)
    ref_out = capsys.readouterr().out.splitlines()
    got = count_parameters(model, display=True)
    out = capsys.readouterr().out.splitlines()
    assert got == ref > 0
    assert out[-1] == ref_out[-1] == f"Total Trainable Params: {ref}"
    assert len(out) == len(named_parameters(model)) + 3
    assert len(named_parameters(model)) == len(jax.tree_util.tree_leaves(params))


def test_count_parameters_skips_frozen():
    model = torch.nn.Linear(3, 2)
    model.bias.requires_grad_(False)
    assert named_parameters(model) == [("weight", 6)]
    assert count_parameters(model, display=False) == 6


def test_metrics_stream_reads_across_packages(tmp_path):
    """Records written by either package's writer read back identically
    through both ``read_metrics``; each line starts with ``index`` and
    ``time``, the index counting from 0."""
    recs = [{"epoch": 0, "train_loss": 1.5}, {"epoch": 1, "test_accuracy": 0.25}]
    for writer, name in ((MetricsWriter, "port"), (JaxMetricsWriter, "jax")):
        path = str(tmp_path / name / "m.jsonl")
        with writer(path) as w:
            for r in recs:
                w.write(r)
        got, ref = read_metrics(path), jax_read_metrics(path)
        assert got == ref
        assert [r["index"] for r in got] == [0, 1]
        assert [{k: v for k, v in r.items() if k not in ("index", "time")}
                for r in got] == recs
        with open(path) as f:
            assert [list(json.loads(line))[:2] for line in f] == [["index", "time"]] * 2
    # appends, as the JAX writer does, and blank lines are skipped
    path = str(tmp_path / "port" / "m.jsonl")
    with open(path, "a") as f:
        f.write("\n")
    with MetricsWriter(path) as w:
        w.write({"epoch": 2})
    assert [r.get("epoch") for r in read_metrics(path)] == [0, 1, 2]
    assert read_metrics(path) == jax_read_metrics(path)


def test_assert_finite_tree_names_the_leaf_as_jax_does():
    """The same message as the JAX function on a nested tree of arrays
    (path, count of non-finite values, shape), also for tensors; a state
    dict is a tree too; a finite tree passes."""
    bad = np.array([1.0, np.nan, np.inf], np.float32)
    tree = {"a": [np.zeros(2, np.float32), bad], "b": np.float32(1.0)}
    with pytest.raises(FloatingPointError) as ref:
        jax_assert_finite_tree(tree, name="grads")
    with pytest.raises(FloatingPointError) as got:
        assert_finite_tree(tree, name="grads")
    assert str(got.value) == str(ref.value) == \
        "grads/a/[1]: 2 non-finite values (shape (3,))"
    torch_tree = {"a": [torch.zeros(2), torch.from_numpy(bad)], "b": 1.0}
    with pytest.raises(FloatingPointError, match=r"^grads/a/\[1\]: 2 non-finite"):
        assert_finite_tree(torch_tree, name="grads")
    model = torch.nn.Linear(3, 4)
    assert_finite_tree(model.state_dict())
    with torch.no_grad():
        model.weight[1, 2] = float("-inf")
    with pytest.raises(FloatingPointError,
                       match=r"^tree/weight: 1 non-finite values \(shape \(4, 3\)\)"):
        assert_finite_tree(model.state_dict())


def test_nan_debugging_names_the_backward_op():
    x = torch.zeros(1, requires_grad=True)
    (torch.sqrt(x) * 0).sum().backward()  # 0 · inf: a NaN gradient, no error
    assert torch.isnan(x.grad).all()
    enable_nan_debugging()
    try:
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="SqrtBackward0"):
            (torch.sqrt(x) * 0).sum().backward()
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def test_check_jit_purity():
    w = torch.arange(6.0).reshape(2, 3)
    assert check_jit_purity(lambda a: {"y": a @ w.T, "n": [a.sum()]}, torch.ones(4, 3))
    calls = []

    def impure(a):
        calls.append(1)
        return a * len(calls)

    assert not check_jit_purity(impure, torch.ones(3))
    assert check_jit_purity(impure, torch.ones(3), atol=10.0)


def test_time_fn_and_trace(tmp_path):
    calls = []

    def fn(a):
        calls.append(1)
        return {"out": a * len(calls)}

    seconds, out = time_fn(fn, torch.ones(4), iters=3, warmup=2)
    assert seconds > 0 and len(calls) == 5
    assert torch.equal(out["out"], torch.full((4,), 5.0))
    device_sync(out)  # a CPU tensor: nothing to wait for
    device_sync({"none": []})
    log_dir = str(tmp_path / "trace")
    with trace(log_dir):
        with span("utils.block"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        count("utils.items", 5)
        count_device("utils.nonzero", torch.tensor([1, 0, 2]))
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.get("name") == "utils.block" and e.get("cat") == "user_annotation"
               for e in events)
    with open(os.path.join(log_dir, "counters.json")) as f:
        got = json.load(f)
    assert got["utils.items"] == 5 and got["utils.nonzero"] == 3
    count("utils.items", 5)  # no profiler: not counted
    with trace(log_dir):  # a second block holds its own counts only
        count("utils.items", 2)
    with open(os.path.join(log_dir, "counters.json")) as f:
        got = json.load(f)
    assert got["utils.items"] == 2 and got["utils.nonzero"] == 0
