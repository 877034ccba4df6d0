"""Max-of-set regression toy (counterpart of
``pcaudio/tasks/max_regression.py``; the vendored demo notebook
``set_transformer-master/max_regression_demo.ipynb``): predict max(set) with
a small Set Transformer (SAB×2 → PMA) vs DeepSet-style pooling (max / mean /
sum), comparing MAE learning curves.

Both models take torch's default init, where the JAX ones' ``nn.Dense``
layers take flax's (lecun-normal, zero bias): runs from each package's own
init are not comparable step by step (the tests carry weights across,
``checkpoint.small_*_state_dict_from_jax``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.nn.attention import PMA, SAB


class SmallSetTransformer(nn.Module):
    """The notebook's model: SAB(64)×2 → PMA(1 seed) → Linear(1); ``[B, N,
    dim_input]`` → ``[B]``."""

    def __init__(self, dim_hidden: int = 64, num_heads: int = 4,
                 dim_input: int = 1):
        super().__init__()
        self.sab0 = SAB(dim_input, dim_hidden, num_heads)
        self.sab1 = SAB(dim_hidden, dim_hidden, num_heads)
        self.pma = PMA(dim_hidden, num_heads, 1)
        self.out = nn.Linear(dim_hidden, 1)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.sab1(self.sab0(x, mask), mask)
        return self.out(self.pma(x, mask))[:, 0, 0]


class SmallDeepSet(nn.Module):
    """Per-point MLP → pool (``max``, ``mean`` or ``sum``) over the set →
    MLP; ``[B, N, dim_input]`` → ``[B]``."""

    def __init__(self, pool: str = "max", dim_hidden: int = 64,
                 dim_input: int = 1):
        super().__init__()
        if pool not in ("max", "mean", "sum"):
            raise ValueError(pool)
        self.pool = pool
        self.enc = nn.Sequential(nn.Linear(dim_input, dim_hidden), nn.ReLU(),
                                 nn.Linear(dim_hidden, dim_hidden), nn.ReLU())
        self.dec = nn.Sequential(nn.Linear(dim_hidden, dim_hidden), nn.ReLU(),
                                 nn.Linear(dim_hidden, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.enc(x)
        if self.pool == "max":
            x = x.amax(dim=-2)
        elif self.pool == "mean":
            x = x.mean(dim=-2)
        else:
            x = x.sum(dim=-2)
        return self.dec(x)[:, 0]


def sample_batch(generator: torch.Generator, batch_size: int = 64,
                 set_size: int = 10):
    """``(x [batch_size, set_size, 1], max(x) [batch_size])``, x ~ N(0, 2²),
    on the generator's device."""
    x = torch.randn((batch_size, set_size, 1), generator=generator,
                    device=generator.device) * 2.0
    return x, x[..., 0].amax(dim=-1)


def train(model: nn.Module, *, steps: int = 500, lr: float = 1e-3,
          seed: int = 0, log=None, device="cuda"):
    """Train ``model`` (its weights as given) on the max-regression task with
    Adam, a fresh batch a step from a generator seeded with ``seed``;
    returns ``(model, final MAE)``.  Runs on ``device``: the card unless the
    caller names the CPU."""
    device = resolve_device(device)
    model = model.to(device).train()
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    generator = torch.Generator(device=device).manual_seed(seed)
    loss = None
    for t in range(steps):
        x, y = sample_batch(generator)
        loss = (model(x) - y).abs().mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        if log and t % 100 == 0:
            log(f"step {t}: MAE {loss.item():.4f}")
    return model, float(loss.detach())
