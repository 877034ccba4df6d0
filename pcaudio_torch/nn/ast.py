"""The Audio Spectrogram Transformer (Gong, Chung, Glass, Interspeech 2021,
arXiv:2104.01778), with the layer equations of ``transformers``'
``ASTForAudioClassification``:

* patches: the ``[T, F]`` log-mel grid (``max_length`` frames of
  ``num_mel_bins``), seen as a ``[F, T]`` image, is cut into
  ``patch × patch`` squares at strides ``(fstride, tstride)``, overlapping;
  the patches run frequency-major (the convolution's ``flatten(2)``), each
  flattened ``(f, t)``, and one Linear projects them (an unfold and a
  matrix product: the convolution of ``transformers`` as im2col);
* tokens: a cls token and a distillation token before the patches, and a
  learned position embedding added to all of them;
* ``depth`` pre-LN blocks, ``x += proj(MHA(LN1 x))`` then
  ``x += fc2(gelu(fc1(LN2 x)))`` (erf GELU), with Q, K and V from one fused
  Linear laid out ``[3, heads, dim / heads]`` and the scale
  ``(dim / heads)^-1/2``;
* a final LN, the mean of the two special tokens, and the head
  ``Linear(LN(pooled))``.

The module computes in its parameters' type.  In bf16 (serving), LayerNorm
takes its statistics in f32 (PyTorch's kernels do), products sum in f32,
the attention's softmax is f32 (kernel K5 or its twin), and the logits come
out in f32: the head multiplies its bf16 operands in f32.  Attention goes
through ``attend``, kernel K5 (``ops/kernels/attn.py``, its plain twin on
CPU tensors) unless another is given; each call is a span ``pipeline.attn``
under a profiler.
``checkpoint.ast_state_dict_from_hf`` maps the names of ``transformers``'
model onto this one's.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from pcaudio_torch.ops.kernels.attn import HEAD_DIM, attn_fwd
from pcaudio_torch.utils.profiling import span


class ASTBlock(nn.Module):
    """One pre-LN encoder block."""

    def __init__(self, dim: int, heads: int, mlp: int, eps: float):
        super().__init__()
        if dim != heads * HEAD_DIM:
            raise ValueError(f"dim {dim} must be heads ({heads}) x {HEAD_DIM}: "
                             f"kernel K5 takes heads of {HEAD_DIM}")
        self.heads = heads
        self.ln1 = nn.LayerNorm(dim, eps=eps)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim, eps=eps)
        self.fc1 = nn.Linear(dim, mlp)
        self.fc2 = nn.Linear(mlp, dim)

    def forward(self, x: torch.Tensor, attend: Callable) -> torch.Tensor:
        qkv = self.qkv(self.ln1(x))
        with span("pipeline.attn"):
            a = attend(qkv, self.heads, 1.0 / math.sqrt(HEAD_DIM))
        x = x + self.proj(a)
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class AST(nn.Module):
    """``features [B, max_length, num_mel_bins]`` → logits ``[B,
    num_labels]`` f32 (see the module)."""

    def __init__(self, num_mel_bins: int = 128, max_length: int = 1024, patch: int = 16,
                 fstride: int = 10, tstride: int = 10, dim: int = 768, depth: int = 12,
                 heads: int = 12, mlp: int = 3072, num_labels: int = 527,
                 eps: float = 1e-12):
        super().__init__()
        self.num_mel_bins, self.max_length = num_mel_bins, max_length
        self.patch_size, self.fstride, self.tstride = patch, fstride, tstride
        self.f_out = (num_mel_bins - patch) // fstride + 1
        self.t_out = (max_length - patch) // tstride + 1
        self.num_tokens = self.f_out * self.t_out + 2
        self.patch = nn.Linear(patch * patch, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos = nn.Parameter(torch.zeros(1, self.num_tokens, dim))
        self.blocks = nn.ModuleList(ASTBlock(dim, heads, mlp, eps) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=eps)
        self.head_norm = nn.LayerNorm(dim, eps=eps)
        self.head = nn.Linear(dim, num_labels)

    def patches(self, features: torch.Tensor) -> torch.Tensor:
        """``[B, T, F]`` → ``[B, f_out·t_out, patch²]``: frequency-major
        patches, each flattened ``(f, t)``."""
        p = self.patch_size
        x = features.transpose(1, 2).unfold(1, p, self.fstride).unfold(2, p, self.tstride)
        return x.reshape(features.shape[0], self.f_out * self.t_out, p * p)

    def embed(self, features: torch.Tensor) -> torch.Tensor:
        """The tokens ``[B, num_tokens, dim]`` in the parameters' type."""
        w = self.patch.weight
        x = F.linear(self.patches(features.to(w.dtype)), w, self.patch.bias)
        B = x.shape[0]
        x = torch.cat([self.cls_token.expand(B, -1, -1), self.dist_token.expand(B, -1, -1), x],
                      dim=1)
        return x + self.pos

    def encode(self, x: torch.Tensor, attend: Callable = attn_fwd) -> torch.Tensor:
        """The blocks, with attention ``attend(qkv, heads, scale)``."""
        for blk in self.blocks:
            x = blk(x, attend)
        return x

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        """Final LN, the two special tokens' mean, and the head: f32 logits."""
        x = self.norm(x)
        pooled = self.head_norm((x[:, 0] + x[:, 1]) / 2)
        return F.linear(pooled.float(), self.head.weight.float(), self.head.bias.float())

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.classify(self.encode(self.embed(features)))
