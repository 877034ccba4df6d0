"""The paper's Set Transformer classifier in plain PyTorch, f32, from a dict
of parameters (``Code/models.py:13-44`` over
``set_transformer-master/modules.py``).

The published equations, with the reference code's conventions: heads are
feature splits, the scale is 1/sqrt(dim_V) for every head, the residual
adds the projected query, the row-wise feed-forward is one ReLU'd Linear,
and no LayerNorm.  A boolean key mask leaves masked points out of each
attend over the set (MAB0 of each ISAB and the PMA); a row with no valid
key attends to nothing.

``rnd`` rounds each matrix product's operands (and, in the backward, the
incoming gradient): identity for the stated f32, or a lower precision for
the comparison's control (``precision.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from pcbench.reference.precision import exact, matmul


def linear(x, w, b, rnd: Callable = exact):
    return matmul(x, w.t(), rnd) + b


def mab(p: Dict[str, torch.Tensor], pre: str, Q, K, mask: Optional[torch.Tensor],
        heads: int, rnd: Callable = exact):
    q = linear(Q, p[pre + ".fc_q.weight"], p[pre + ".fc_q.bias"], rnd)
    k = linear(K, p[pre + ".fc_k.weight"], p[pre + ".fc_k.bias"], rnd)
    v = linear(K, p[pre + ".fc_v.weight"], p[pre + ".fc_v.bias"], rnd)
    B, nq, d = q.shape
    nk = k.shape[1]
    dh = d // heads
    qh = q.reshape(B, nq, heads, dh).transpose(1, 2)
    kh = k.reshape(B, nk, heads, dh).transpose(1, 2)
    vh = v.reshape(B, nk, heads, dh).transpose(1, 2)
    s = matmul(qh, kh.transpose(-1, -2), rnd) / math.sqrt(d)
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    a = torch.softmax(s, dim=-1)
    if mask is not None:
        a = torch.where(mask.any(-1)[:, None, None, None], a, torch.zeros_like(a))
    o = q + matmul(a, vh, rnd).transpose(1, 2).reshape(B, nq, d)
    return o + torch.relu(linear(o, p[pre + ".fc_o.weight"], p[pre + ".fc_o.bias"], rnd))


def st_forward(p: Dict[str, torch.Tensor], X: torch.Tensor,
               mask: Optional[torch.Tensor] = None, heads: int = 8,
               rnd: Callable = exact) -> torch.Tensor:
    """``X [B, n, d_in]`` (and ``mask [B, n]``) → logits ``[B, classes]``."""
    B = X.shape[0]
    for i in (0, 1):
        ind = p[f"enc.{i}.I"].expand(B, -1, -1)
        H = mab(p, f"enc.{i}.mab0", ind, X, mask, heads, rnd)
        X = mab(p, f"enc.{i}.mab1", X, H, None, heads, rnd)
    seeds = p["dec.0.S"].expand(B, -1, -1)
    x = mab(p, "dec.0.mab", seeds, X, mask, heads, rnd)
    return linear(x[:, 0], p["dec.1.weight"], p["dec.1.bias"], rnd)


def st_forward_blocks(p, X, mask=None, heads: int = 8, rnd: Callable = exact,
                      block: int = 4096) -> torch.Tensor:
    """:func:`st_forward` over blocks of ``block`` clouds, without autograd."""
    out = []
    with torch.no_grad():
        for i in range(0, X.shape[0], block):
            m = None if mask is None else mask[i: i + block]
            out.append(st_forward(p, X[i: i + block].float(), m, heads, rnd))
    return torch.cat(out)
