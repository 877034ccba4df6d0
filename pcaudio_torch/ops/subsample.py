"""Point-cloud subsampling policies: top-K, random-K, zero-replace, and
spectral-flux importance sampling (counterpart of
``pcaudio/ops/subsample.py``), batched over the leading axes.

Every selection goes through one ranking, :func:`topk_stable`: a stable
sort that gives ``lax.top_k``'s order (descending, ties to the lower index,
-0.0 tying with 0.0), so the exact forms select what the JAX package
selects.  ``torch.topk`` is not used: its order among ties is not specified
on CUDA.  The random forms draw from an explicit ``torch.Generator`` and
cannot match ``jax.random`` bit for bit; they match it in distribution.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries of the last axis,
    in ``jax.lax.top_k``'s order: descending, ties to the lower index.
    The sort key is ``0.0 - x``, which maps -0.0 to +0.0, so the two tie
    whatever the sort's key transform; the values returned are ``x``'s
    own."""
    idx = torch.sort(0.0 - x, dim=-1, stable=True).indices[..., :k]
    return x.gather(-1, idx), idx


def _take_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points [..., N, d]`` at ``idx [..., k]`` → ``[..., k, d]``."""
    return points.gather(-2, idx[..., None].expand(*idx.shape, points.shape[-1]))


def _uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator, device=device)


# ---------- cloud side (keep K points) ----------

def top_k_points(points: torch.Tensor, k: int, value_axis: int = -1) -> torch.Tensor:
    """Keep the K highest-magnitude points of each cloud: ``points [..., N,
    d]`` → ``[..., k, d]`` by descending coordinate ``value_axis``
    (``pc_maxK``, ``Code/utils.py:25-53``)."""
    _, idx = topk_stable(points[..., value_axis], k)
    return _take_points(points, idx)


def rand_k_points(generator: torch.Generator, points: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Keep K uniformly random points without replacement: the top K of
    i.i.d. uniform noise (``pc_randK``, ``Code/utils.py:55-82``)."""
    noise = _uniform(generator, points.shape[:-1], points.device)
    _, idx = topk_stable(noise, k)
    return _take_points(points, idx)


def top_k_points_masked(points: torch.Tensor, mask: torch.Tensor, k: int,
                        value_axis: int = -1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-K of padded clouds: an invalid point scores the dtype's
    lowest finite value, so it is chosen only after every valid one.
    Returns ``(points [..., k, d], mask [..., k])``; the mask, gathered
    with the points, flags the selections that are real."""
    mags = points[..., value_axis]
    mask = mask.to(device=mags.device, dtype=torch.bool)
    neg = torch.finfo(mags.dtype).min
    _, idx = topk_stable(torch.where(mask, mags, neg), k)
    return _take_points(points, idx), mask.gather(-1, idx)


def rand_k_points_masked(generator: torch.Generator, points: torch.Tensor,
                         mask: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked uniform K without replacement over the valid points only
    (invalid points score -1, below any noise)."""
    mask = mask.to(device=points.device, dtype=torch.bool)
    noise = _uniform(generator, points.shape[:-1], points.device)
    _, idx = topk_stable(torch.where(mask, noise, -1.0), k)
    return _take_points(points, idx), mask.gather(-1, idx)


# ---------- grid side (zero the cells not kept; the baselines) ----------

def _keep_only(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    keep = torch.zeros_like(x, dtype=torch.bool).scatter_(-1, idx, True)
    return torch.where(keep, x, 0.0)


def top_k_replace(x: torch.Tensor, k: int) -> torch.Tensor:
    """Zero all but the K largest entries of the last axis
    (``pc_maxK_replace``, ``Code/utils.py:86-95``)."""
    return _keep_only(x, topk_stable(x, k)[1])


def rand_k_replace(generator: torch.Generator, x: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Zero all but K uniformly random entries of the last axis
    (``pc_randK_replace``, ``Code/utils.py:97-106``)."""
    return _keep_only(x, topk_stable(_uniform(generator, x.shape, x.device), k)[1])


def grid_top_k_replace(grid: torch.Tensor, k: int, flag: str = "max",
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """CNN-baseline grid subsampling (``ESC_baseline_temporal_maxK``,
    ``Code/dataset.py:102-135``): keep the top-K (``flag="max"``) or K
    random (``"rand"``) cells of each ``[..., Nt, F]`` grid, flattened
    frequency-fastest, and zero the rest."""
    flat = grid.reshape(*grid.shape[:-2], -1)
    if flag == "max":
        out = top_k_replace(flat, k)
    elif flag == "rand":
        if generator is None:
            raise ValueError("flag 'rand' needs a generator")
        out = rand_k_replace(generator, flat, k)
    else:
        raise ValueError(f"flag must be 'max' or 'rand', got {flag!r}")
    return out.reshape(grid.shape)


# ---------- spectral-flux importance sampling (the rebuttal experiment) ----------

def _corr1d(x: torch.Tensor, taps: torch.Tensor, dim: int) -> torch.Tensor:
    """Cross-correlation along ``dim`` with torch's 'same' padding
    (``(k-1)//2`` zeros before, ``k//2`` after, no flip), as weighted sums
    of shifted slices: a ``conv2d`` would go to cuDNN, which takes f32
    convolutions in TF32 by default on the card."""
    k, n = taps.shape[0], x.shape[dim]
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [(k - 1) // 2, k // 2]
    xp = torch.nn.functional.pad(x, pad)
    out = taps[0] * xp.narrow(dim, 0, n)
    for j in range(1, k):
        out = out + taps[j] * xp.narrow(dim, j, n)
    return out


def importance_heatmap(grid_tf: torch.Tensor, win_f: int,
                       beta: float = 5.09) -> torch.Tensor:
    """Spectral-flux sampling heat-map (``Code/dataset.py:281-284``) of
    ``[..., Nt, F]`` grids, in f32: ``|∂_f x| + |∂_t x|`` (central
    differences, one-sided at the edges: ``torch.gradient``), smoothed by
    a separable Kaiser kernel, ``win_f`` taps along time and 2 along
    frequency (``torch.kaiser_window(n, periodic=True, beta=beta)``, the
    reference's ``kaiser(2)[:, None] @ kaiser(winF)[None, :]`` on its
    frequency-major grid), then ``+ 1e-6``."""
    x = grid_tf.float()
    g = (torch.gradient(x, dim=-1)[0].abs()
         + torch.gradient(x, dim=-2)[0].abs())
    kw = dict(periodic=True, beta=beta, dtype=torch.float32, device=x.device)
    g = _corr1d(g, torch.kaiser_window(win_f, **kw), dim=-2)   # time
    g = _corr1d(g, torch.kaiser_window(2, **kw), dim=-1)       # frequency
    return g + 1.0e-6


def importance_indices(heat_tf: torch.Tensor, k: int, choice: int,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """K flat indices from ``[..., Nt, F]`` heat-maps, with the reference's
    index-space mismatch kept on purpose: the heat is flattened
    frequency-major (``g.view(-1)`` of its ``[F, Nt]`` grid,
    ``Code/dataset.py:285-290``) while cloud rows are frequency-fastest,
    and the indices apply to cloud rows as they are; the paper's numbers
    came from it.  ``choice=0``: K draws with replacement, each index with
    probability heat / Σ heat; ``choice=1``: the top K of the heat."""
    flat = heat_tf.transpose(-1, -2).reshape(*heat_tf.shape[:-2], -1)
    if choice == 0:
        if generator is None:
            raise ValueError("choice=0 (multinomial) needs a generator")
        rows = flat.reshape(-1, flat.shape[-1])
        idx = torch.multinomial(rows, k, replacement=True, generator=generator)
        return idx.reshape(*flat.shape[:-1], k)
    return topk_stable(flat, k)[1]


def importance_sample_cloud(cloud: torch.Tensor, heat_tf: torch.Tensor, k: int,
                            choice: int,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """:func:`importance_indices` applied to frequency-fastest clouds
    ``[..., Nt·F, 3]`` (``Code/dataset.py:286-291``) → ``[..., k, 3]``."""
    return _take_points(cloud, importance_indices(heat_tf, k, choice, generator))
