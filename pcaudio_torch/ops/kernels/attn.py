"""Unmasked self-attention at head width 64 over a fused QKV product:
kernel K5 (``csrc/attn.cu``; the JAX package has no counterpart, as it
has no AST) and its plain PyTorch twin.

``qkv [B, N, 3·H·64]`` is the fused Q, K, V projection's output as it lies
(``[B, N, 3, H, 64]``); the result is ``softmax(q·kᵀ·scale)·v`` for every
(clip, head) as ``[B, N, H·64]``, the out-projection's input.  The kernel
takes bf16 and sums in f32: the softmax's maxima, exps and sums in f32, the
probabilities rounded to bf16 as the second product's operand, the output
rounded to bf16 once.  CPU tensors take :func:`attn_fwd_plain`, which does
the same arithmetic in one pass over the keys; CUDA tensors always take the
kernel, and a shape or type it does not take raises.
"""
from __future__ import annotations

import math

import torch

from pcaudio_torch.ops.kernels import _build

HEAD_DIM = 64
LOG2E = 1.0 / math.log(2.0)
# the kernel by name, as a profiler lists it
KERNELS = ("attn_fwd_kernel",)


def _split(qkv: torch.Tensor, heads: int):
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * heads * HEAD_DIM:
        raise ValueError(f"qkv [B, N, 3·{heads}·{HEAD_DIM}] expected, got "
                         f"{tuple(qkv.shape)}")
    B, N, _ = qkv.shape
    return B, N


def attn_fwd_plain(qkv: torch.Tensor, heads: int, scale: float,
                   block: int = 16) -> torch.Tensor:
    """The kernel's function step by step, ``block`` clips at a time: f32
    scores of the operands as given, ``p = 2^(s·scale·log2 e − max)``, the
    row sums of the f32 ``p``, ``p`` rounded to the operands' type for the
    product with ``v``, the division, and the result in that type."""
    B, N = _split(qkv, heads)
    out = []
    for i in range(0, B, block):
        x = qkv[i: i + block].reshape(-1, N, 3, heads, HEAD_DIM)
        q, k, v = (t.float() for t in x.unbind(2))      # [b, N, H, 64]
        s = torch.einsum("bnhd,bmhd->bhnm", q, k) * (scale * LOG2E)
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        l = p.sum(-1)                                     # [b, H, N]
        o = torch.einsum("bhnm,bmhd->bnhd", p.to(qkv.dtype).float(), v)
        o = o / l.transpose(1, 2)[..., None]
        out.append(o.to(qkv.dtype).reshape(-1, N, heads * HEAD_DIM))
    return torch.cat(out)


def attn_fwd(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """``qkv [B, N, 3·heads·64]`` → ``[B, N, heads·64]`` (see the module)."""
    if qkv.device.type == "cpu":
        return attn_fwd_plain(qkv, heads, scale)
    B, N = _split(qkv, heads)
    if qkv.dtype != torch.bfloat16 or not (qkv.is_cuda and qkv.is_contiguous()):
        raise ValueError("qkv must be a contiguous bfloat16 CUDA tensor")
    out = torch.empty((B, N, heads * HEAD_DIM), dtype=torch.bfloat16, device=qkv.device)
    _build.launch("pcaudio_attn_fwd", qkv.data_ptr(), out.data_ptr(), B, N, heads,
                  float(scale), _build.stream_of(qkv))
    attn_fwd.launches += 1
    return out


attn_fwd.launches = 0
