"""Masked set-attention blocks: MAB / SAB / ISAB / PMA
(counterpart of ``pcaudio/nn/attention.py``).

Parameter names follow the reference (``set_transformer-master/modules.py``):
``fc_q``/``fc_k``/``fc_v``/``fc_o`` linears, ``I`` inducing points, ``S``
seeds, so a reference state dict loads with ``load_state_dict``.  The
reference's quirks are kept, because the shipped checkpoints depend on them:

  * the attention scale is ``1/sqrt(dim_V)``, not per head;
  * heads are feature splits: head i sees features ``[i·dh, (i+1)·dh)``;
  * the residual adds the *projected* query;
  * the rFF is a single ReLU'd linear;
  * no LayerNorms (``ln=False``, every shipped checkpoint).

Every block takes an optional boolean key mask; rows whose keys are all
masked attend to nothing and get zeros, not NaN.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` attending only where ``mask`` is True.

    ``mask`` broadcasts against ``logits``.  Rows whose keys are ALL masked
    return zeros.  With ``mask=None`` this is ``torch.softmax``.
    """
    if mask is None:
        return torch.softmax(logits, dim=dim)
    finfo = torch.finfo(logits.dtype)
    masked = torch.where(mask, logits, finfo.min)
    m = masked.amax(dim=dim, keepdim=True)
    unnorm = torch.exp(masked - m) * mask
    denom = unnorm.sum(dim=dim, keepdim=True)
    return unnorm / denom.clamp_min(finfo.tiny)


class MAB(nn.Module):
    """Multihead Attention Block: ``o = Q' + Att(Q', K', V')``,
    ``MAB(Q, K) = o + relu(fc_o(o))``."""

    def __init__(self, dim_Q: int, dim_K: int, dim_V: int, num_heads: int):
        super().__init__()
        if dim_V % num_heads:
            raise ValueError(f"dim_V={dim_V} not divisible by "
                             f"num_heads={num_heads}")
        self.dim_V = dim_V
        self.num_heads = num_heads
        self.fc_q = nn.Linear(dim_Q, dim_V)
        self.fc_k = nn.Linear(dim_K, dim_V)
        self.fc_v = nn.Linear(dim_K, dim_V)
        self.fc_o = nn.Linear(dim_V, dim_V)

    def forward(self, Q: torch.Tensor, K: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``Q [B, N, dim_Q]``, ``K [B, M, dim_K]``, ``key_mask [B, M]`` bool
        → ``[B, N, dim_V]``."""
        dv, h = self.dim_V, self.num_heads
        q, k, v = self.fc_q(Q), self.fc_k(K), self.fc_v(K)
        B, N, M = q.shape[0], q.shape[1], k.shape[1]
        qh = q.view(B, N, h, dv // h)
        kh = k.view(B, M, h, dv // h)
        vh = v.view(B, M, h, dv // h)
        logits = torch.einsum("bnhd,bmhd->bhnm", qh, kh) * (1.0 / math.sqrt(dv))
        mask_b = None if key_mask is None else key_mask[:, None, None, :]
        attn = masked_softmax(logits, mask_b, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, vh).reshape(B, N, dv)
        o = q + out
        return o + torch.relu(self.fc_o(o))


class SAB(nn.Module):
    """Self-Attention Block: ``SAB(X) = MAB(X, X)``."""

    def __init__(self, dim_in: int, dim_out: int, num_heads: int):
        super().__init__()
        self.mab = MAB(dim_in, dim_in, dim_out, num_heads)

    def forward(self, X, mask=None):
        return self.mab(X, X, key_mask=mask)


class ISAB(nn.Module):
    """Induced Set Attention Block: ``H = MAB0(I, X)`` over the masked set,
    then ``MAB1(X, H)`` unmasked (H is always fully valid)."""

    def __init__(self, dim_in: int, dim_out: int, num_heads: int,
                 num_inds: int):
        super().__init__()
        self.I = nn.Parameter(torch.empty(1, num_inds, dim_out))
        nn.init.xavier_uniform_(self.I)
        self.mab0 = MAB(dim_out, dim_in, dim_out, num_heads)
        self.mab1 = MAB(dim_in, dim_out, dim_out, num_heads)

    def forward(self, X, mask=None):
        H = self.mab0(self.I.expand(X.shape[0], -1, -1), X, key_mask=mask)
        return self.mab1(X, H)


class PMA(nn.Module):
    """Pooling by Multihead Attention: ``num_seeds`` learned seeds attend
    over the masked set → ``[B, num_seeds, dim]``."""

    def __init__(self, dim: int, num_heads: int, num_seeds: int):
        super().__init__()
        self.S = nn.Parameter(torch.empty(1, num_seeds, dim))
        nn.init.xavier_uniform_(self.S)
        self.mab = MAB(dim, dim, dim, num_heads)

    def forward(self, X, mask=None):
        return self.mab(self.S.expand(X.shape[0], -1, -1), X, key_mask=mask)
