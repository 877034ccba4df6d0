"""Train and eval steps (counterpart of ``pcaudio/train/step.py``).

Cross-entropy on the model's logits and one optimizer step.  PyTorch runs
eagerly, so a step updates the model and the optimizer in place instead of
returning a new state; the metrics stay device tensors, so a loop that does
not read them each step does not wait for the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the count of optimizer steps taken, and
    the generator its dropout masks are drawn from (None without
    dropout)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    generator: Optional[torch.Generator] = None


def make_train_step(apply_fn: Callable[[Batch], torch.Tensor],
                    optimizer: torch.optim.Optimizer
                    ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """``step(batch) -> {"loss", "accuracy"}``: forward in training mode
    (dropout on), backward and one ``optimizer`` step.  ``batch["labels"]``
    holds integer labels ``[B]``."""

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        logits = apply_fn(batch, train=True)
        labels = batch["labels"].long()
        loss = F.cross_entropy(logits, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return step


def make_eval_step(apply_fn: Callable[[Batch], torch.Tensor]
                   ) -> Callable[[Batch], Tuple[torch.Tensor, int]]:
    """``step(batch) -> (correct_count, total)`` in eval mode (dropout off);
    the count stays a device tensor."""

    @torch.no_grad()
    def step(batch: Batch) -> Tuple[torch.Tensor, int]:
        logits = apply_fn(batch)
        correct = (logits.argmax(-1) == batch["labels"].long()).sum()
        return correct, batch["labels"].shape[0]

    return step
