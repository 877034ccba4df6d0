"""ModelNet40 classification recipe (counterpart of
``pcaudio/tasks/modelnet40.py``), the generic set-encoder cross-check.

Re-implementation of ``set_transformer-master/main_pointcloud.py``: the
ModelNet40 ``SetTransformer`` variant (ISAB×2 → Dropout → PMA → Dropout →
Linear), metrics streamed to the JSONL metrics writer instead of
TensorBoard.  The optimizer is plain Adam at a fixed rate, as the JAX code
has it (``optax.adam``); the JAX module's docstring mentions a ×0.1 decay
step that its code does not take, and the port follows the code.  Dropout
masks come from a ``torch.Generator`` seeded from ``seed``, so they cannot
match ``jax.random``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.data.modelnet40 import ModelNet40Fetcher
from pcaudio_torch.nn import SetTransformer
from pcaudio_torch.train.step import TrainState, make_eval_step, make_train_step


@dataclasses.dataclass
class ModelNet40Config:
    """Mirror of the reference CLI (``main_pointcloud.py:40-48``)."""

    num_pts: int = 1000
    learning_rate: float = 1e-3
    batch_size: int = 64
    dim: int = 256
    n_heads: int = 4
    n_anc: int = 16
    train_epochs: int = 2000
    dim_output: int = 40

    @property
    def exp_name(self) -> str:
        return (f"N{self.num_pts}_d{self.dim}h{self.n_heads}i{self.n_anc}"
                f"_lr{self.learning_rate}bs{self.batch_size}")


def build(cfg: ModelNet40Config, device="cuda"):
    """``(model, optimizer)``: the ModelNet40 Set Transformer on ``device``
    (the card unless the caller names the CPU), its weights drawn from torch
    seed 0 as the JAX ``build`` inits from key 0, and Adam at
    ``cfg.learning_rate``."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = SetTransformer(
            dim_input=3, num_outputs=1, dim_output=cfg.dim_output,
            num_inds=cfg.n_anc, dim_hidden=cfg.dim, num_heads=cfg.n_heads,
            pointcloud_variant=True)
    model = model.to(device)
    return model, torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)


def make_steps(model, optimizer, generator: torch.Generator):
    """``(train_step, eval_step)`` on batches ``{"points" [B, K, 3],
    "labels" [B]}``: the train step (``train.step.make_train_step``) runs
    the model in training mode, its dropout drawing from ``generator``, and
    returns ``{"loss", "accuracy"}``; the eval step runs it in eval mode and
    returns ``(correct, total)``."""

    def apply_fn(batch, train: bool = False):
        if model.training != train:
            model.train(train)
        return model(batch["points"], generator=generator)

    return make_train_step(apply_fn, optimizer), make_eval_step(apply_fn)


def train(
    cfg: ModelNet40Config,
    data: Union[str, ModelNet40Fetcher],
    *,
    epochs: Optional[int] = None,
    eval_every: int = 10,
    metrics=None,
    seed: int = 0,
    log=print,
    device="cuda",
):
    """Train on a ModelNet40 h5 file (a path) or a
    :class:`ModelNet40Fetcher`; returns ``(state, history)``.

    From a path the fetcher down-samples each cloud to about ``num_pts``
    points (``10000 / num_pts``), standardizes, and augments only at 5,000
    points, as the JAX ``train`` does.  Each epoch's record (``epoch``,
    ``train_loss``, ``train_accuracy``, and ``test_accuracy`` every
    ``eval_every`` epochs) goes to ``history`` and to ``metrics.write``.
    Per-step metrics stay on the device until the epoch ends."""
    if isinstance(data, ModelNet40Fetcher):
        fetcher = data
    else:
        fetcher = ModelNet40Fetcher(
            data, cfg.batch_size,
            down_sample=max(1, int(10000 / cfg.num_pts)),
            do_standardize=True, do_augmentation=(cfg.num_pts == 5000),
            seed=seed)
    model, optimizer = build(cfg, device)
    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(seed)
    state = TrainState(model, optimizer, generator=generator)
    train_step, eval_step = make_steps(model, optimizer, generator)

    def batch(clouds, labels):
        return {"points": torch.from_numpy(np.ascontiguousarray(
                    clouds, dtype=np.float32)).to(dev, non_blocking=True),
                "labels": torch.from_numpy(labels).to(dev, non_blocking=True)}

    history = []
    for epoch in range(epochs if epochs is not None else cfg.train_epochs):
        losses, accs = [], []
        for clouds, _, labels in fetcher.train_data():
            m = train_step(batch(clouds, labels))
            state.step += 1
            losses.append(m["loss"])
            accs.append(m["accuracy"])
        rec = {"epoch": epoch,
               "train_loss": float(torch.stack(losses).double().mean()),
               "train_accuracy": float(torch.stack(accs).double().mean())}
        if epoch % eval_every == 0:
            correct, total = torch.zeros((), dtype=torch.long, device=dev), 0
            for clouds, _, labels in fetcher.test_data():
                c, t = eval_step(batch(clouds, labels))
                correct, total = correct + c, total + t
            rec["test_accuracy"] = int(correct) / max(total, 1)
        history.append(rec)
        if metrics is not None:
            metrics.write(rec)
        log(f"epoch {epoch}: loss {rec['train_loss']:.3f} "
            f"acc {rec['train_accuracy']:.3f}"
            + (f" test {rec['test_accuracy']:.3f}" if "test_accuracy" in rec else ""))
    return state, history
