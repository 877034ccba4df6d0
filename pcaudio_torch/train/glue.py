"""Adapters binding the set models to the generic train/eval steps
(counterpart of ``pcaudio/train/glue.py``)."""
from __future__ import annotations


def pointcloud_apply(model):
    """For set models (ST): batch keys ``points [B, K, d]``, optional
    ``mask [B, K]``, ``labels [B]``; returns ``apply_fn(batch) -> logits``."""

    def apply_fn(batch):
        return model(batch["points"], batch.get("mask"))

    return apply_fn
