"""Train and eval steps (counterpart of ``pcaudio/train/step.py``).

Cross-entropy on the model's logits and one optimizer step.  PyTorch runs
eagerly, so a step updates the model and the optimizer in place instead of
returning a new state; the metrics stay device tensors, so a loop that does
not read them each step does not wait for the device.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

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


class _OnlyGenerator(TorchFunctionMode):
    """Raises on a draw from any ``torch.Generator`` but ``allowed``: under
    ``remat`` the recompute could not draw that generator's numbers
    again."""

    def __init__(self, allowed: Optional[torch.Generator]):
        super().__init__()
        self.allowed = allowed

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        g = kwargs.get("generator")
        if g is not None and g is not self.allowed:
            raise RuntimeError(
                f"remat: the forward draws from a torch.Generator "
                f"({getattr(func, '__name__', func)}) that the step was not "
                f"given, so the recompute would draw other numbers: pass "
                f"generator= (the TrainState's) to make_train_step")
        return func(*args, **kwargs)


def _remat_contexts(generator: Optional[torch.Generator]):
    """``checkpoint``'s ``context_fn``: the checkpointed forward runs under
    :class:`_OnlyGenerator` and notes ``generator``'s state; the recompute
    starts from that state, and ``generator`` is left where the forward
    left it.  (``preserve_rng_state`` covers only the default CPU and CUDA
    generators.)"""
    before = None if generator is None else generator.get_state()

    @contextlib.contextmanager
    def recompute():
        if generator is None:
            yield
            return
        after = generator.get_state()
        generator.set_state(before)
        try:
            yield
        finally:
            generator.set_state(after)

    return _OnlyGenerator(generator), recompute()


def _remat(fn, generator: Optional[torch.Generator]):
    """``fn`` run under non-reentrant ``torch.utils.checkpoint``, the
    generator restored for its recompute (:func:`_remat_contexts`)."""

    def run(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: _remat_contexts(generator), **kwargs)

    return run


@contextlib.contextmanager
def _checkpointed(modules: Sequence[torch.nn.Module],
                  generator: Optional[torch.Generator]):
    """Each module's calls run under :func:`_remat` inside the block (its
    ``forward`` shadowed by an instance attribute, removed on exit)."""
    patched = []
    try:
        for m in modules:
            if "forward" in vars(m):
                raise ValueError(f"{type(m).__name__} is listed twice in remat, "
                                 f"or its forward is already replaced")
            m.forward = _remat(m.forward, generator)
            patched.append(m)
        yield
    finally:
        for m in patched:
            del m.forward


def make_train_step(apply_fn: Callable[[Batch], torch.Tensor],
                    optimizer: torch.optim.Optimizer,
                    remat: Union[bool, Sequence[torch.nn.Module]] = False,
                    generator: Optional[torch.Generator] = None
                    ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """``step(batch) -> {"loss", "accuracy"}``: forward in training mode
    (dropout on), backward and one ``optimizer`` step.  ``batch["labels"]``
    holds integer labels ``[B]``.

    ``remat`` recomputes activations in the backward instead of storing
    them, under non-reentrant ``torch.utils.checkpoint``:

      * ``True`` checkpoints the whole forward, as the JAX step's
        ``jax.checkpoint`` does.  Nothing is held between forward and
        backward, but the backward recomputes the whole forward before its
        first node, so the step's peak memory is the plain step's;
      * a sequence of modules checkpoints each one's calls separately
        (for an ``ST``: ``[model.enc[0], model.enc[1], model.dec[0]]``):
        only their inputs are held, and the backward recomputes one
        module's activations at a time, which lowers the peak.

    Either way each checkpointed forward runs twice.  The recompute must
    draw the forward's dropout masks again: ``generator`` is the generator
    the adapter draws from (the ``TrainState``'s), set back for each
    recompute; a checkpointed forward that draws from any other generator
    raises ``RuntimeError`` instead of taking the gradient of another
    network.  ``generator`` is used only with ``remat``."""

    def forward(batch: Batch) -> torch.Tensor:
        if remat is True:
            return _remat(apply_fn, generator)(batch, train=True)
        if not remat:
            return apply_fn(batch, train=True)
        with _checkpointed(remat, generator):
            return apply_fn(batch, train=True)

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        logits = forward(batch)
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
