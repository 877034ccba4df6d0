"""The epoch loop: shuffled minibatches, periodic eval, checkpoints and resume
(counterpart of ``pcaudio/train/loop.py``).

The batch order is ``np.random.default_rng(seed).permutation`` per epoch,
exactly the JAX loop's ``_batches``.  When the data fits in device memory
the loop keeps it there and gathers each batch on the device; per-step
metrics stay device tensors, read once per epoch.  Over a mesh of ranks
every rank draws the same permutation and takes its shard of each global
batch.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from pcaudio_torch.train.step import TrainState, wrapped_set_axis


def _batches(n: int, batch_size: int,
             rng: np.random.Generator) -> Iterator[np.ndarray]:
    """One epoch's batches of indices; the remainder is dropped."""
    order = rng.permutation(n)
    for i in range(0, (n // batch_size) * batch_size, batch_size):
        yield order[i: i + batch_size]


def _fits_on_device(arrays, device: torch.device) -> bool:
    """Half the device's free memory is left for the model and its
    activations; the CPU holds the data where it is anyway."""
    if device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    return sum(a.nbytes for a in arrays) <= free // 2


def _silent(msg: str) -> None:
    pass


def _data_sum(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the mesh's ``data`` ranks (a copy)."""
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return t


def _tensors(data: Dict[str, Any], device: torch.device,
             resident: bool) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) if resident else torch.as_tensor(v)
            for k, v in data.items()}


def fit(state: TrainState, train_step: Callable, data: Dict[str, Any], *,
        batch_size: int, epochs: int, seed: int = 0,
        eval_data: Optional[Dict[str, Any]] = None,
        eval_step: Optional[Callable] = None, eval_every: int = 10,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: Optional[int] = None, config=None,
        resume: bool = False, max_steps: Optional[int] = None,
        mesh=None, shard_set_axis: Optional[bool] = None,
        log: Callable[[str], None] = print):
    """Run the training loop; returns ``(state, history)``.

    ``data``/``eval_data`` are dicts of equal-leading-dim arrays (numpy or
    torch; must include ``labels``, and the inputs the adapter reads:
    ``points`` for the set models, ``x`` for the baselines), moved to the model's device whole when
    they fit in half its free memory, else batch by batch.
    ``train_step(batch)`` updates
    ``state.model`` through ``state.optimizer``; ``eval_step(batch) ->
    (correct, total)``.  Each epoch's record holds its mean loss and
    accuracy and every ``step_losses`` value.  ``resume=True`` continues
    from the latest checkpoint in ``checkpoint_dir``, drawing the batches
    an uninterrupted run would draw, and the dropout masks too where
    ``state.generator`` is set.  ``max_steps`` ends the run after that
    many optimizer steps in all.

    With a ``mesh`` (``parallel.make_mesh``) every rank runs this loop:
    ``batch_size`` is the global batch, each rank draws the same
    permutation from ``seed`` and takes its shard of each batch with
    ``parallel.shard_batch(mesh, batch, shard_set_axis)`` (the data stay on
    the host, as in the JAX loop with a mesh).  ``train_step`` must be
    built on ``data_parallel(state.model, mesh, shard_set_axis)``, which
    decides whether the point axis is sharded: ``shard_set_axis`` defaults
    to that call's, and one that differs from it, or a model that
    ``data_parallel`` did not wrap over this mesh, raises.  The epoch's
    losses and accuracies are averaged over the ``data`` ranks and the eval
    counts summed over them, so every rank returns the same history; rank
    0 alone logs and writes checkpoints, and every rank loads them on
    ``resume``.
    """
    from pcaudio_torch.checkpoint import (
        latest_step, load_checkpoint, save_checkpoint)

    if mesh is not None:
        set_axis = wrapped_set_axis(state.model, mesh)
        if shard_set_axis is not None and shard_set_axis != set_axis:
            raise ValueError(f"fit(shard_set_axis={shard_set_axis}), but the train "
                             f"step's module was made by data_parallel(..., "
                             f"shard_set_axis={set_axis})")
        shard_set_axis = set_axis
    device = next(state.model.parameters()).device
    n = len(data["labels"])
    if n < batch_size:
        raise ValueError(f"{n} examples make no batch of {batch_size}")
    lead = mesh is None or mesh.rank == 0
    if not lead:
        log = _silent
    device_resident = mesh is None and _fits_on_device(
        list(data.values()) + list((eval_data or {}).values()), device)
    data = _tensors(data, device, device_resident)
    if eval_data is not None:
        eval_data = _tensors(eval_data, device, device_resident)

    rng = np.random.default_rng(seed)
    start = 0
    if resume and checkpoint_dir and latest_step(checkpoint_dir) is not None:
        tree, start = load_checkpoint(checkpoint_dir, map_location=device)
        state.model.load_state_dict(tree["model"])
        state.optimizer.load_state_dict(tree["optimizer"])
        state.step = tree["train_steps"]
        if state.generator is not None:
            state.generator.set_state(tree["generator"].cpu())
        for _ in range(start):  # the permutations of the epochs done
            rng.permutation(n)
        log(f"resumed from epoch {start} ({state.step} steps)")

    def batch_of(arrays, idx):
        if mesh is not None:
            from pcaudio_torch.parallel.mesh import shard_batch

            idx = torch.from_numpy(idx)
            return shard_batch(mesh, {k: v[idx] for k, v in arrays.items()},
                               shard_set_axis)
        if device_resident:
            idx = torch.from_numpy(idx).to(device, non_blocking=True)
            return {k: v[idx] for k, v in arrays.items()}
        idx = torch.from_numpy(idx)
        return {k: v[idx].to(device, non_blocking=True)
                for k, v in arrays.items()}

    history: List[Dict[str, Any]] = []
    for epoch in range(start, epochs):
        t0 = time.perf_counter()
        losses, accs = [], []
        for idx in _batches(n, batch_size, rng):
            metrics = train_step(batch_of(data, idx))
            state.step += 1
            losses.append(metrics["loss"])
            accs.append(metrics["accuracy"])
            if max_steps is not None and state.step >= max_steps:
                break
        # one device sync per epoch: the per-step metrics were device tensors
        metrics = torch.stack([torch.stack(losses), torch.stack(accs)])
        if mesh is not None:
            metrics = _data_sum(mesh, metrics) / mesh.n_data
        step_losses, step_accs = metrics.cpu()
        rec = {
            "epoch": epoch,
            "train_loss": float(step_losses.mean()),
            "train_accuracy": float(step_accs.mean()),
            "step_losses": step_losses.tolist(),
            "seconds": time.perf_counter() - t0,
        }
        if (eval_data is not None and eval_step is not None
                and epoch % eval_every == 0):
            correct = torch.zeros((), dtype=torch.long, device=device)
            total = 0
            ne = len(eval_data["labels"])
            for i in range(0, ne - batch_size + 1, batch_size):
                c, t = eval_step(batch_of(eval_data, np.arange(i, i + batch_size)))
                correct += c
                total += t
            if mesh is not None:
                correct, total = _data_sum(
                    mesh, torch.stack([correct, torch.tensor(total, device=device)])
                ).tolist()
            rec["test_accuracy"] = int(correct) / max(total, 1)
        history.append(rec)
        msg = (f"Epoch {epoch}: train loss {rec['train_loss']:.3f} "
               f"train acc {rec['train_accuracy']:.3f}")
        if "test_accuracy" in rec:
            msg += f" test acc {rec['test_accuracy']:.3f}"
        log(msg)
        if (checkpoint_dir and checkpoint_every
                and (epoch + 1) % checkpoint_every == 0):
            if lead:
                save_checkpoint(checkpoint_dir, state, config, step=epoch + 1)
            if mesh is not None:   # no rank reads a checkpoint being written
                dist.barrier(group=mesh.group)
        if max_steps is not None and state.step >= max_steps:
            break
    return state, history
