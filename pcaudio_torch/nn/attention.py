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
  * ``ln=True`` adds LayerNorms ``ln0`` after the attention residual and
    ``ln1`` after the rFF residual, at torch's ε 1e-5 (flax's default,
    which the JAX package's MAB takes, is 1e-6); every shipped checkpoint
    has ``ln=False``.

Every block takes an optional boolean key mask; rows whose keys are all
masked attend to nothing and get zeros, not NaN.  ``fused_attn=True``
routes ``softmax(q·kᵀ·scale, mask)·v`` through kernel K4
(``ops/kernels/mha.py::fused_mha``, forward and backward) for training;
the default is its plain version, the masked einsum-softmax.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pcaudio_torch.ops.kernels.mha import fused_mha, fused_mha_plain


class MAB(nn.Module):
    """Multihead Attention Block: ``o = LN0(Q' + Att(Q', K', V'))``,
    ``MAB(Q, K) = LN1(o + relu(fc_o(o)))``, the LayerNorms only with
    ``ln=True``."""

    def __init__(self, dim_Q: int, dim_K: int, dim_V: int, num_heads: int,
                 fused_attn: bool = False, ln: bool = False):
        super().__init__()
        if dim_V % num_heads:
            raise ValueError(f"dim_V={dim_V} not divisible by "
                             f"num_heads={num_heads}")
        self.dim_V = dim_V
        self.num_heads = num_heads
        self.fused_attn = fused_attn
        self.ln = ln
        self.fc_q = nn.Linear(dim_Q, dim_V)
        self.fc_k = nn.Linear(dim_K, dim_V)
        self.fc_v = nn.Linear(dim_K, dim_V)
        if ln:
            self.ln0 = nn.LayerNorm(dim_V)
            self.ln1 = nn.LayerNorm(dim_V)
        self.fc_o = nn.Linear(dim_V, dim_V)

    def forward(self, Q: torch.Tensor, K: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``Q [B, N, dim_Q]``, ``K [B, M, dim_K]``, ``key_mask [B, M]`` bool
        → ``[B, N, dim_V]``."""
        q, k, v = self.fc_q(Q), self.fc_k(K), self.fc_v(K)
        attend = fused_mha if self.fused_attn else fused_mha_plain
        o = q + attend(q, k, v, key_mask, self.num_heads,
                       1.0 / math.sqrt(self.dim_V))
        if self.ln:
            o = self.ln0(o)
        o = o + torch.relu(self.fc_o(o))
        return self.ln1(o) if self.ln else o


class SAB(nn.Module):
    """Self-Attention Block: ``SAB(X) = MAB(X, X)``."""

    def __init__(self, dim_in: int, dim_out: int, num_heads: int,
                 fused_attn: bool = False, ln: bool = False):
        super().__init__()
        self.mab = MAB(dim_in, dim_in, dim_out, num_heads, fused_attn, ln)

    def forward(self, X, mask=None):
        return self.mab(X, X, key_mask=mask)


class ISAB(nn.Module):
    """Induced Set Attention Block: ``H = MAB0(I, X)`` over the masked set,
    then ``MAB1(X, H)`` unmasked (H is always fully valid)."""

    def __init__(self, dim_in: int, dim_out: int, num_heads: int,
                 num_inds: int, fused_attn: bool = False, ln: bool = False):
        super().__init__()
        self.I = nn.Parameter(torch.empty(1, num_inds, dim_out))
        nn.init.xavier_uniform_(self.I)
        self.mab0 = MAB(dim_out, dim_in, dim_out, num_heads, fused_attn, ln)
        self.mab1 = MAB(dim_in, dim_out, dim_out, num_heads, fused_attn, ln)

    def forward(self, X, mask=None):
        H = self.mab0(self.I.expand(X.shape[0], -1, -1), X, key_mask=mask)
        return self.mab1(X, H)


class PMA(nn.Module):
    """Pooling by Multihead Attention: ``num_seeds`` learned seeds attend
    over the masked set → ``[B, num_seeds, dim]``."""

    def __init__(self, dim: int, num_heads: int, num_seeds: int,
                 fused_attn: bool = False, ln: bool = False):
        super().__init__()
        self.S = nn.Parameter(torch.empty(1, num_seeds, dim))
        nn.init.xavier_uniform_(self.S)
        self.mab = MAB(dim, dim, dim, num_heads, fused_attn, ln)

    def forward(self, X, mask=None):
        return self.mab(self.S.expand(X.shape[0], -1, -1), X, key_mask=mask)
