"""Adapters binding the model zoo to the generic train/eval steps
(counterpart of ``pcaudio/train/glue.py``).

An adapter is ``apply_fn(batch, train=False) -> logits``.  ``train`` puts
the model in training mode (dropout on) or eval mode (dropout off), as the
JAX adapters switch on whether the step passes an rng; the train step
passes ``train=True``, the eval step nothing.
"""
from __future__ import annotations

import torch


def _mode(model: torch.nn.Module, train: bool) -> None:
    if model.training != train:
        model.train(train)


def pointcloud_apply(model):
    """For set models without dropout (ST, DeepSet): batch keys ``points
    [B, K, d]``, optional ``mask [B, K]``, ``labels [B]``."""

    def apply_fn(batch, train: bool = False):
        _mode(model, train)
        return model(batch["points"], batch.get("mask"))

    return apply_fn


def dropout_apply(model, generator: torch.Generator):
    """For BaselineFF and CNNClassifier: batch keys ``x`` and ``labels``;
    the input dropout draws from ``generator`` in the train step and is off
    in the eval step (the reference's ``model.train()`` /
    ``model.eval()``)."""

    def apply_fn(batch, train: bool = False):
        _mode(model, train)
        return model(batch["x"], generator=generator)

    return apply_fn
