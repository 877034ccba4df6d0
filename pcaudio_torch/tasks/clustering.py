"""Amortized mixture-of-Gaussians clustering (counterpart of
``pcaudio/tasks/clustering.py``; the vendored library's demo task,
``set_transformer-master/run.py`` + ``mixture_of_mvns.py`` +
``mvn_diag.py``).

A set model reads N points and emits K component parameter vectors
``[K, 1 + 2·dim]`` parsed as (logit π, μ, softplus σ); the loss is the
negative mixture log-likelihood of the observed set.  Benchmark mode compares
the model's likelihood against the generating ("oracle") parameters on a
fixed sampled benchmark, as ``run.py:113-135`` does.

Mixtures are drawn from a ``torch.Generator``, so they cannot match
``jax.random``'s draws; the set sizes N are ``np.random.default_rng(seed)``'s,
the JAX sequence exactly.  The clustering ST has ``ln=True``: its LayerNorm ε
is torch's 1e-5 where flax's is 1e-6.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.nn import DeepSet, SetTransformer
from pcaudio_torch.train.step import TrainState

Tensor = torch.Tensor


def sample_mog(generator: torch.Generator, B: int, N: int, K: int,
               dim: int = 2) -> Tuple[Tensor, Tensor, Tensor, Tuple[Tensor, Tensor]]:
    """Sample B mixture problems on the generator's device (``mvn_diag.py:
    10-22``'s generative process): π ~ Dirichlet(1), as K Exp(1) draws
    normalised to sum 1; per-point labels ~ Cat(π); μ ~ U(-4, 4); σ = 0.3.

    Returns ``(X [B,N,dim], labels [B,N], pi [B,K], (mu [B,K,dim], sigma))``.
    """
    dev = generator.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    e = -torch.log1p(-uniform(B, K))  # Exp(1); 1 - U lies in (0, 1]
    pi = e / e.sum(-1, keepdim=True)
    labels = torch.multinomial(pi, N, replacement=True, generator=generator)
    mu = -4.0 + 8.0 * uniform(B, K, dim)
    sigma = torch.full((B, K, dim), 0.3, device=dev)
    eps = torch.randn((B, N, dim), generator=generator, device=dev)
    X = torch.gather(mu, 1, labels[..., None].expand(B, N, dim)) + eps * 0.3
    return X, labels, pi, (mu, sigma)


def diag_mvn_log_prob(X: Tensor, mu: Tensor, sigma: Tensor) -> Tensor:
    """Per-component diagonal-Gaussian log density: ``X [B,N,d]``,
    ``mu/sigma [B,K,d]`` → ``[B,N,K]`` (``mvn_diag.py:24-33``)."""
    diff = X[:, :, None, :] - mu[:, None, :, :]
    s = sigma[:, None, :, :]
    ll = (-0.5 * math.log(2.0 * math.pi) - torch.log(s)
          - 0.5 * (diff / s) ** 2)
    return ll.sum(dim=-1)


def mog_log_likelihood(X: Tensor, pi: Tensor, mu: Tensor, sigma: Tensor,
                       return_labels: bool = False):
    """Mean mixture log-likelihood (``mixture_of_mvns.py:39-46``); with
    ``return_labels`` also each point's most likely component."""
    ll = diag_mvn_log_prob(X, mu, sigma) + torch.log(pi + 1e-10)[:, None, :]
    out = torch.logsumexp(ll, dim=-1).mean()
    if return_labels:
        return out, ll.argmax(dim=-1)
    return out


def parse_raw(raw: Tensor, dim: int):
    """Network output ``[B, K, 1+2·dim]`` → (π, μ, σ) (``mvn_diag.py:39-42``)."""
    pi = torch.softmax(raw[..., 0], dim=-1)
    mu = raw[..., 1: 1 + dim]
    sigma = F.softplus(raw[..., 1 + dim:])
    return pi, mu, sigma


@dataclasses.dataclass
class ClusteringConfig:
    """Mirror of the reference CLI (``run.py:17-32`` defaults)."""

    model: str = "set_transformer"  # or "deepset"
    K: int = 4
    dim: int = 2
    N_min: int = 100
    N_max: int = 500
    B: int = 10
    num_steps: int = 50000
    lr: float = 1e-3


def build(cfg: ClusteringConfig, device="cuda"):
    """``(model, optimizer, scheduler)``: the model on ``device`` (the card
    unless the caller names the CPU) with weights drawn from torch seed 0,
    as the JAX ``build`` inits from key 0; Adam at ``cfg.lr``, ×0.1 from
    update ``num_steps // 2`` on (``run.py:86-87``).  Step the scheduler
    after each optimizer step: optax counts updates from 0, and
    ``MultiStepLR`` then gives update t the JAX schedule's rate at t."""
    device = resolve_device(device)
    out_per_k = 1 + 2 * cfg.dim
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        if cfg.model == "set_transformer":
            model = SetTransformer(dim_input=cfg.dim, num_outputs=cfg.K,
                                   dim_output=out_per_k, num_inds=32,
                                   dim_hidden=128, num_heads=4, ln=True)
        elif cfg.model == "deepset":
            model = DeepSet(dim_input=cfg.dim, num_outputs=cfg.K,
                            dim_output=out_per_k, dim_hidden=256)
        else:
            raise ValueError(cfg.model)
    model = model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    scheduler = torch.optim.lr_scheduler.MultiStepLR(
        optimizer, [cfg.num_steps // 2], 0.1)
    return model, optimizer, scheduler


def _loss(model, X: Tensor, dim: int) -> Tensor:
    return -mog_log_likelihood(X, *parse_raw(model(X), dim))


def make_train_step(model, optimizer, scheduler, cfg: ClusteringConfig):
    """``step(X) -> loss``: the negative log-likelihood of ``X [B, N, dim]``
    under the model's mixture, one Adam update and one schedule step; the
    loss stays a device tensor."""

    def step(X: Tensor) -> Tensor:
        loss = _loss(model, X, cfg.dim)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        scheduler.step()
        return loss.detach()

    return step


def train(cfg: ClusteringConfig, *, num_steps: Optional[int] = None,
          seed: int = 0, log_every: int = 1000, log=print,
          checkpoint_dir: Optional[str] = None,
          checkpoint_every: Optional[int] = None, device="cuda"):
    """Train the amortized clusterer on freshly sampled mixtures each step
    (N drawn uniformly in [N_min, N_max] from ``np.random.default_rng
    (seed)``, the JAX sequence; the mixtures from a generator on ``device``
    seeded with ``seed``), saving a checkpoint (``checkpoint.
    save_checkpoint``) every ``checkpoint_every`` steps as ``run.py:105-110``
    does.  Returns ``(model, state, losses)``: ``state.step`` counts the
    updates, ``losses`` holds each step's loss on the device (the JAX
    ``train`` returns ``(model, state)`` and keeps only what it logs)."""
    from pcaudio_torch.checkpoint import save_checkpoint

    model, optimizer, scheduler = build(cfg, device)
    state = TrainState(model, optimizer)
    step_fn = make_train_step(model, optimizer, scheduler, cfg)
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=next(model.parameters()).device)
    generator.manual_seed(seed)
    steps = num_steps if num_steps is not None else cfg.num_steps
    losses = []
    for t in range(steps):
        N = int(rng.integers(cfg.N_min, cfg.N_max + 1))
        X, *_ = sample_mog(generator, cfg.B, N, cfg.K, cfg.dim)
        losses.append(step_fn(X))
        state.step += 1
        if t % log_every == 0:
            log(f"step {t}: -ll {float(losses[-1]):.4f}")
        if checkpoint_dir and checkpoint_every and (t + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, state, step=t + 1)
    return model, state, torch.stack(losses) if losses else torch.zeros(0)


@torch.no_grad()
def benchmark(model, cfg: ClusteringConfig, *, num_batches: int = 100,
              seed: int = 1):
    """Model vs oracle likelihood on a fixed benchmark (``run.py:113-135``):
    ``num_batches`` batches of ``N_max`` points from a generator seeded with
    ``seed`` on the model's device.  Returns ``(model_ll, oracle_ll)``
    (higher is better), each the mean over the batches."""
    generator = torch.Generator(device=next(model.parameters()).device)
    generator.manual_seed(seed)
    model_ll, oracle_ll = [], []
    for _ in range(num_batches):
        X, _, pi, (mu, sigma) = sample_mog(generator, cfg.B, cfg.N_max, cfg.K,
                                           cfg.dim)
        model_ll.append(mog_log_likelihood(X, *parse_raw(model(X), cfg.dim)))
        oracle_ll.append(mog_log_likelihood(X, pi, mu, sigma))
    return (float(torch.stack(model_ll).double().mean()),
            float(torch.stack(oracle_ll).double().mean()))
