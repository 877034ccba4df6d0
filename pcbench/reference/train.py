"""The FST training step in plain PyTorch: the ST forward, the mean
cross-entropy, autograd's backward and Adam with L2 weight decay
(``torch.optim.Adam(lr, weight_decay)``, the paper's optimizer), written
out: g ← ∇L + wd·θ; m ← β1·m + (1 − β1)·g; v ← β2·v + (1 − β2)·g²;
θ ← θ − lr · (m / (1 − β1^t)) / (sqrt(v / (1 − β2^t)) + ε).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from pcbench.reference.precision import exact
from pcbench.reference.st import st_forward


def train_steps(params0: Dict[str, torch.Tensor], batches: Sequence[dict],
                heads: int, lr: float, weight_decay: float,
                betas=(0.9, 0.999), eps: float = 1e-8, rnd: Callable = exact):
    """Steps over ``batches`` (``points``, ``labels``) from ``params0``.
    Returns ``(losses, first gradients, parameters after the last step)``;
    a first gradient is Adam's, with the decay term."""
    p = {n: t.detach().clone().float().requires_grad_(True) for n, t in params0.items()}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    b1, b2 = betas
    losses: List[float] = []
    first = None
    for t, batch in enumerate(batches, start=1):
        logits = st_forward(p, batch["points"], batch.get("mask"), heads, rnd)
        loss = F.cross_entropy(logits, batch["labels"].long())
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gs = {}
            for (n, w), g in zip(p.items(), grads):
                g = g + weight_decay * w
                gs[n] = g
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n] / (1 - b2 ** t)).sqrt() + eps
                w.sub_(lr * (m[n] / (1 - b1 ** t)) / denom)
            if first is None:
                first = gs
        del logits, loss, grads
    return losses, first, {n: w.detach() for n, w in p.items()}
