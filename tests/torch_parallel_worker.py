"""One rank of a ``gloo`` world for tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py WORLD RANK SIZE WORKDIR

Reads ``WORKDIR/inputs.npz`` (written by the test), joins the world through
``file://WORKDIR/store``, runs the world's cases and writes what it found
to ``WORKDIR/rank<RANK>.npz``.  It imports only torch and pcaudio_torch.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from pcaudio_torch import checkpoint
from pcaudio_torch.eval import TemporalPipelineConfig, extract_chunk_clouds
from pcaudio_torch.nn import ST
from pcaudio_torch.parallel import (
    global_batch_array, global_mesh, initialize_distributed, local_batch_slice,
    make_mesh, replicated, set_sharded_st_forward, shard_batch)
from pcaudio_torch.train import (
    TrainState, data_parallel, fit, make_eval_step, make_train_step,
    pointcloud_apply)
from pcaudio_torch.utils import collective_calls

# the JAX tests' models (tests/test_set_sharded.py, tests/test_train.py)
ARCH = {"w32": dict(dim_input=3, dim_output=10, num_inds=16, dim_hidden=32, num_heads=4),
        "w16": dict(dim_input=2, dim_output=10, num_inds=8, dim_hidden=16, num_heads=4),
        "w8": dict(dim_input=2, dim_output=2, num_inds=4, dim_hidden=8, num_heads=2)}
MESHES = ((1, 4), (2, 2), (4, 1))
# the pipeline case: tests/test_set_sharded.py:65-94's config
PIPE_CFG = TemporalPipelineConfig(fs=44100, n_fft=1024, num_frames=10, top_k=64,
                                  extraction="exact")
SGD_LR = 1e-2


def st(inputs, key):
    model = ST(**ARCH[key])
    model.load_state_dict({k[len(key) + 1:]: torch.from_numpy(v)
                           for k, v in inputs.items() if k.startswith(key + "/")})
    return model


def params_of(model, prefix):
    return {f"{prefix}/{n}": p.detach().numpy().copy()
            for n, p in model.named_parameters()}


def world_set(rank, size, inputs, out):
    """4 ranks: the set-sharded forward at (1, 4), (2, 2), (4, 1), its
    collectives, gradients, the serving pipeline, the DP step and fit with
    the set axis, and the mesh helpers."""
    pts, mask = inputs["pts"], inputs["mask"]
    model = st(inputs, "w32")
    for nd, ns in MESHES:
        mesh = make_mesh(nd, ns, device="cpu")
        groups = {"set": mesh.set_group, "data": mesh.data_group}
        x = shard_batch(mesh, {"points": pts, "mask": mask}, shard_set_axis=True)
        with collective_calls(groups) as fwd_calls:
            logits = set_sharded_st_forward(model, x["points"], x["mask"], mesh)
        with collective_calls(groups) as bwd_calls:
            logits.sum().backward()
        model.zero_grad(set_to_none=True)
        out[f"fwd/{nd}x{ns}"] = logits.detach().numpy()
        out[f"calls/{nd}x{ns}"] = np.array(json.dumps([fwd_calls, bwd_calls]))
        out[f"coords/{nd}x{ns}"] = np.array([mesh.data_index, mesh.set_index])
        out[f"slice/{nd}x{ns}"] = np.array(
            [(s := local_batch_slice(8, mesh)).start, s.stop])

    # the gradient rule at (1, 4): the ranks' gradients averaged (what DDP
    # does) against jax.grad
    mesh = make_mesh(1, 4, device="cpu")
    gm = st(inputs, "w16")
    x = shard_batch(mesh, {"points": inputs["g_pts"], "mask": inputs["g_mask"]},
                    shard_set_axis=True)
    loss = F.cross_entropy(set_sharded_st_forward(gm, x["points"], x["mask"], mesh),
                           torch.from_numpy(inputs["g_labels"]).long())
    loss.backward()
    for n, p in gm.named_parameters():
        dist.all_reduce(p.grad)
        out[f"grad/{n}"] = (p.grad / size).numpy()
    out["g_loss"] = np.array(loss.item())

    # the serving pipeline at (2, 2): the port's clouds, set-sharded logits
    mesh = make_mesh(2, 2, device="cpu")
    waves = torch.from_numpy(inputs["waves"])
    cloud, _ = extract_chunk_clouds(waves, torch.full((waves.shape[0],), waves.shape[1]),
                                    PIPE_CFG)
    x = shard_batch(mesh, {"points": cloud.points, "mask": cloud.mask},
                    shard_set_axis=True)
    with torch.no_grad():
        out["pipe"] = set_sharded_st_forward(model, x["points"], x["mask"], mesh).numpy()

    # one DP step at (2, 2) through DDP over the set-sharded forward, SGD
    model = st(inputs, "w8")
    ddp = data_parallel(model, mesh, shard_set_axis=True)
    opt = torch.optim.SGD(model.parameters(), lr=SGD_LR)
    step = make_train_step(pointcloud_apply(ddp), opt)
    batch = shard_batch(mesh, {"points": inputs["dp_pts"], "labels": inputs["dp_labels"]},
                        shard_set_axis=True)
    m = step(batch)
    out["dp_loss"] = np.array(m["loss"].item())
    out.update(params_of(model, "dp_params"))
    out.update({f"dp_grad/{n}": p.grad.numpy().copy() for n, p in model.named_parameters()})

    # fit over (2, 2) with the set axis, SGD, an eval each epoch
    model = st(inputs, "w8")
    ddp = data_parallel(model, mesh, shard_set_axis=True)
    opt = torch.optim.SGD(model.parameters(), lr=SGD_LR)
    _, hist = fit(TrainState(model, opt), make_train_step(pointcloud_apply(ddp), opt),
                  {"points": inputs["fit_pts"], "labels": inputs["fit_labels"]},
                  batch_size=8, epochs=2, seed=0,
                  eval_data={"points": inputs["fit_pts"], "labels": inputs["fit_labels"]},
                  eval_step=make_eval_step(pointcloud_apply(ddp)), eval_every=1,
                  mesh=mesh, shard_set_axis=True, log=lambda _: None)
    out["fit_loss"] = np.array([h["train_loss"] for h in hist])
    out["fit_acc"] = np.array([h["test_accuracy"] for h in hist])

    # helpers: shard_batch refuses an axis that does not divide; a second
    # initialize_distributed is a no-op, one with another backend raises
    for bad in (np.zeros((3, 8, 2), np.float32), np.zeros((4, 9, 2), np.float32)):
        try:
            shard_batch(mesh, {"points": bad}, shard_set_axis=True)
            out[f"refused/{bad.shape}"] = np.array(False)
        except ValueError:
            out[f"refused/{bad.shape}"] = np.array(True)
    initialize_distributed(backend="gloo")
    try:
        initialize_distributed(backend="nccl")
        out["other_backend_raised"] = np.array(False)
    except RuntimeError:
        out["other_backend_raised"] = np.array(True)
    g = global_mesh(n_set=2, device="cpu")
    out["global_mesh"] = np.array([g.n_data, g.n_set, g.data_index, g.set_index])
    local = global_batch_array(g, {"x": inputs["dp_labels"][local_batch_slice(8, g)]})
    out["global_batch"] = local["x"].numpy()


def world_dp(rank, size, inputs, out):
    """2 ranks on ``data``: one SGD step and one Adam step through DDP,
    fit with checkpoints and resume, and fit's refusals."""
    mesh = make_mesh(device="cpu")
    batch = shard_batch(mesh, {"points": inputs["dp_pts"], "labels": inputs["dp_labels"]})
    for name, make_opt in (("sgd", lambda p: torch.optim.SGD(p, lr=SGD_LR)),
                           ("adam", lambda p: torch.optim.Adam(p, lr=1e-3,
                                                               weight_decay=1e-3))):
        model = st(inputs, "w8")
        if rank == 1:   # replicated (and DDP) start every rank from rank 0's weights
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        replicated(mesh, model)
        out[f"{name}_replicated_ok"] = np.array(all(
            torch.equal(p, torch.from_numpy(inputs[f"w8/{n}"]))
            for n, p in model.named_parameters()))
        opt = make_opt(model.parameters())
        m = make_train_step(pointcloud_apply(data_parallel(model, mesh)), opt)(batch)
        loss = m["loss"].clone()
        dist.all_reduce(loss, group=mesh.data_group)
        out[f"{name}_loss"] = np.array(loss.item() / mesh.n_data)
        out.update(params_of(model, f"{name}_params"))
        out.update({f"{name}_grad/{n}": p.grad.numpy().copy()
                    for n, p in model.named_parameters()})

    # fit: two epochs with a checkpoint each, then a third resumed
    saves = []
    save = checkpoint.save_checkpoint

    def counting_save(*args, **kwargs):
        saves.append(kwargs.get("step"))
        return save(*args, **kwargs)

    checkpoint.save_checkpoint = counting_save
    data = {"points": inputs["fit_pts"], "labels": inputs["fit_labels"]}
    ckpt = os.path.join(sys.argv[4], "ckpt")
    hists = []
    for epochs, resume in ((2, False), (3, True)):
        model = st(inputs, "w8")
        opt = torch.optim.SGD(model.parameters(), lr=SGD_LR)
        ddp = data_parallel(model, mesh)
        _, hist = fit(TrainState(model, opt), make_train_step(pointcloud_apply(ddp), opt),
                      data, batch_size=8, epochs=epochs, seed=0, eval_data=data,
                      eval_step=make_eval_step(pointcloud_apply(ddp)), eval_every=1,
                      checkpoint_dir=ckpt, checkpoint_every=1, resume=resume,
                      mesh=mesh, log=lambda _: None)
        hists += hist
    out["fit_epochs"] = np.array([h["epoch"] for h in hists])
    out["fit_loss"] = np.array([h["train_loss"] for h in hists])
    out["fit_acc"] = np.array([h["test_accuracy"] for h in hists])
    out["fit_saves"] = np.array(saves, dtype=np.int64)
    out.update(params_of(model, "fit_params"))

    # fit refuses a shard_set_axis other than data_parallel's, and a model
    # that data_parallel did not wrap over this mesh
    for case, wrapped, asked in (("set_axis_not_wrapped", False, True),
                                 ("set_axis_wrapped_not_asked", True, False),
                                 ("not_wrapped", None, None)):
        model = st(inputs, "w8")
        opt = torch.optim.SGD(model.parameters(), lr=SGD_LR)
        module = model if wrapped is None else data_parallel(model, mesh, wrapped)
        try:
            fit(TrainState(model, opt), make_train_step(pointcloud_apply(module), opt),
                data, batch_size=8, epochs=1, mesh=mesh, shard_set_axis=asked,
                log=lambda _: None)
            out[f"refused/{case}"] = np.array(False)
        except ValueError:
            out[f"refused/{case}"] = np.array(True)


WORLDS = {"set": world_set, "dp": world_dp}


def main():
    world, rank, size, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    inputs = dict(np.load(os.path.join(work, "inputs.npz")))
    initialize_distributed(f"file://{os.path.join(work, 'store')}", size, rank, "gloo")
    out = {}
    try:
        WORLDS[world](rank, size, inputs, out)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    main()
