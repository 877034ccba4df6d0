"""Trainable masked multi-head set attention: K4 (``csrc/mha.cu``, the port
of ``pcaudio/ops/kernels/mha.py::fused_mha``), forward and backward, bound
as a ``torch.autograd.Function``, beside its plain PyTorch pair.

``softmax(q·kᵀ·scale, key mask)·v`` with feature-split heads (head h owns
features ``[h·dh, (h+1)·dh)``); masked keys are left out of the softmax, a
row whose keys are all masked gives zeros and zero gradients, and a ``None``
mask means every key is valid.  The scale is the caller's (the reference
MAB passes ``1/sqrt(dim_V)``, not per head).

CPU tensors take the plain pair (:func:`fused_mha_plain` forward,
:func:`fused_mha_bwd_plain` backward); CUDA tensors always take the
kernels, and a shape or type the kernels do not take raises.  The
forward's launch geometry is planned here (:func:`fwd_plan`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from pcaudio_torch.ops.kernels import _build

HEAD_DIMS = (4, 8, 16)  # dh the kernels are compiled for
# csrc/mha.cu's forward: warps a block, 16 query rows a warp, keys a staged
# tile, keys a block compacts at a time
FWD_WARPS, FWD_WARP_ROWS, FWD_KEY_TILE, FWD_WINDOW = 4, 16, 64, 8192
# the forward's CUDA kernels by name, as a profiler lists them
FWD_KERNELS = ("mha_fwd_kernel", "mha_fwd_short_kernel", "mha_fwd_merge_kernel")


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """The forward kernel's geometry: a block holds ``rows`` query rows of
    one (sample, head), ``qtiles`` blocks cover its queries, and ``splits``
    blocks split each row's keys (merged by a second kernel when above 1).
    ``parts`` 1, 2 or 4: the tiled kernel, ``parts`` warps splitting each
    key tile (``rows = 64 / parts``); 0: the kernel for at most 64 keys,
    which splits them once a block and walks ``rows`` rows a block."""

    parts: int
    rows: int
    qtiles: int
    splits: int


def fwd_plan(B: int, N: int, M: int, num_heads: int, sms: int, dh: int = 8) -> FwdPlan:
    """Plan the forward for ``N`` queries and ``M`` keys of head width
    ``dh`` on a card of ``sms`` multiprocessors.

    At most 64 keys and dh ≤ 8 (MAB1's 64 summaries) take the short-key
    kernel, with enough rows a block for about 8 blocks an SM.  Otherwise,
    under 33 queries the warps split each key tile (PMA's one query would
    leave three of four warps idle); and where the blocks would not fill the
    card twice (3ST training's MAB0 and PMA at B = 16: 128 blocks on 132
    SMs), each row's keys are split over up to 4·sms / blocks blocks, each
    taking at least 512 keys."""
    block_rows = FWD_WARPS * FWD_WARP_ROWS
    if M <= FWD_KEY_TILE and dh <= 8:
        tiles = -(-N // block_rows)
        per = -(-tiles // min(tiles, -(-8 * sms // (B * num_heads))))
        return FwdPlan(0, per * block_rows, -(-N // (per * block_rows)), 1)
    parts = 4 if N <= 16 else 2 if N <= 32 else 1
    rows = block_rows // parts
    qtiles = -(-N // rows)
    base = B * num_heads * qtiles
    splits = 1
    if base < 2 * sms:
        splits = max(1, min(-(-4 * sms // base), -(-M // 512)))
    return FwdPlan(parts, rows, qtiles, splits)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, R, dv = x.shape
    return x.reshape(B, R, num_heads, dv // num_heads)


def _probs(q, k, mask, num_heads, scale):
    """Attention probabilities ``[B, h, N, M]``."""
    logits = torch.einsum("bnhd,bmhd->bhnm", _heads(q, num_heads),
                          _heads(k, num_heads)) * scale
    return masked_softmax(logits, None if mask is None
                          else mask[:, None, None, :], dim=-1)


def fused_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor], num_heads: int,
                    scale: float) -> torch.Tensor:
    """Plain version: the port MAB's masked einsum-softmax,
    ``q [B, N, dv]``, ``k``/``v`` ``[B, M, dv]``, ``mask [B, M]`` bool or
    None → ``[B, N, dv]``."""
    B, N, dv = q.shape
    a = _probs(q, k, mask, num_heads, scale)
    return torch.einsum("bhnm,bmhd->bnhd", a,
                        _heads(v, num_heads)).reshape(B, N, dv)


def fused_mha_bwd_plain(q, k, v, mask, g, num_heads: int, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, the formula the kernels implement:
    ``dlg = a ⊙ (g·vᵀ − rowsum(g·vᵀ ⊙ a)) · scale``, then per head
    ``dq = dlg·k``, ``dk = dlgᵀ·q``, ``dv = aᵀ·g``."""
    shape_q, shape_k = q.shape, k.shape
    a = _probs(q, k, mask, num_heads, scale)
    qh, kh, vh, gh = (_heads(x, num_heads) for x in (q, k, v, g))
    da = torch.einsum("bnhd,bmhd->bhnm", gh, vh)
    dlg = a * (da - (da * a).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bhnm,bmhd->bnhd", dlg, kh).reshape(shape_q)
    dk = torch.einsum("bhnm,bnhd->bmhd", dlg, qh).reshape(shape_k)
    dv = torch.einsum("bhnm,bnhd->bmhd", a, gh).reshape(shape_k)
    return dq, dk, dv


def _check(q, k, v, mask, num_heads):
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"q [B, N, dv] and k, v [B, M, dv] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, N, dv = q.shape
    M = k.shape[1]
    if k.shape[0] != B or k.shape[2] != dv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or width")
    if num_heads < 1 or dv % num_heads:
        raise ValueError(f"dv={dv} not divisible by num_heads={num_heads}")
    if mask is not None and tuple(mask.shape) != (B, M):
        raise ValueError(f"mask {tuple(mask.shape)} is not [B, M] = {(B, M)}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base: the kernels move head rows
    as 16-byte vectors."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_args(q, k, v, mask, num_heads):
    """Check what the kernels take; return contiguous, aligned operands."""
    _check(q, k, v, mask, num_heads)
    B, N, dv = q.shape
    if min(B, N, k.shape[1]) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if dv // num_heads not in HEAD_DIMS:
        raise ValueError(f"head width {dv // num_heads} outside the kernel's "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if mask is not None:
        if mask.dtype != torch.bool or mask.device != q.device:
            raise TypeError("mask must be a bool tensor on q's device")
        mask = mask.contiguous()
    return _aligned(q), _aligned(k), _aligned(v), mask


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fused_mha_fwd(q, k, v, mask, num_heads: int, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel (planned by :func:`fwd_plan`): ``(out [B,
    N, dv], lse [B, h, N])``, the row log-sum-exp of the scaled logits (+inf
    for a row with no valid key) that the backward reads.  CUDA tensors
    only."""
    q, k, v, mask = _kernel_args(q, k, v, mask, num_heads)
    B, N, dv = q.shape
    M = k.shape[1]
    plan = fwd_plan(B, N, M, num_heads, _sm_count(q.device.index or 0), dv // num_heads)
    out = torch.empty_like(q)
    lse = torch.empty((B, num_heads, N), dtype=torch.float32, device=q.device)
    part_m = part_l = part_o = None
    if plan.splits > 1:
        part_m = torch.empty((plan.splits, B, num_heads, N), dtype=torch.float32,
                             device=q.device)
        part_l = torch.empty_like(part_m)
        part_o = torch.empty((plan.splits, B, N, dv), dtype=torch.float32,
                             device=q.device)
    _build.launch("pcaudio_mha_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  _ptr(mask), out.data_ptr(), lse.data_ptr(), _ptr(part_m),
                  _ptr(part_l), _ptr(part_o), B, N, M, num_heads, dv // num_heads,
                  plan.parts, plan.rows, plan.splits, float(scale), _build.stream_of(q))
    fused_mha_fwd.launches += 1
    return out, lse


def fused_mha_bwd(q, k, v, mask, out, lse, g, num_heads: int, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels (dq, then dk/dv) on the forward's inputs,
    its ``out`` and ``lse``, and ``g = dL/dout``: ``(dq, dk, dv)``.  CUDA
    tensors only."""
    q, k, v, mask = _kernel_args(q, k, v, mask, num_heads)
    B, N, dv = q.shape
    if g.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} and out {tuple(out.shape)} must "
                         f"be q's shape {tuple(q.shape)}")
    g, out, lse = _aligned(g.to(torch.float32)), _aligned(out), lse.contiguous()
    delta = torch.empty_like(lse)
    dq, dk, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.launch("pcaudio_mha_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  _ptr(mask), out.data_ptr(), lse.data_ptr(), g.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv_.data_ptr(),
                  B, N, k.shape[1], num_heads, dv // num_heads, float(scale),
                  _build.stream_of(q))
    fused_mha_bwd.launches += 1
    return dq, dk, dv_


fused_mha_fwd.launches = 0
fused_mha_bwd.launches = 0


class _FusedMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        if q.device.type == "cpu":
            _check(q, k, v, mask, num_heads)
            ctx.save_for_backward(q, k, v, mask)
            return fused_mha_plain(q, k, v, mask, num_heads, scale)
        out, lse = fused_mha_fwd(q, k, v, mask, num_heads, scale)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, *res = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = fused_mha_bwd_plain(q, k, v, mask, g, ctx.num_heads,
                                        ctx.scale)
        else:
            grads = fused_mha_bwd(q, k, v, mask, *res, g, ctx.num_heads,
                                  ctx.scale)
        return (*grads, None, None, None)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor], num_heads: int,
              scale: float) -> torch.Tensor:
    """``softmax(q·kᵀ·scale, key mask)·v`` with feature-split heads,
    differentiable in q, k and v.

    Args:
      q: ``[B, N, dv]`` projected queries.
      k/v: ``[B, M, dv]`` projected keys / values.
      mask: ``[B, M]`` bool key mask or None (all keys valid).
      num_heads: head count (``dv % num_heads == 0``; the kernels take
        ``dv / num_heads`` in :data:`HEAD_DIMS`).
      scale: logits scale (reference: ``1/sqrt(dv)``).

    Returns ``[B, N, dv]``.  CPU tensors take the plain pair; CUDA tensors
    (float32) the kernels, whose launches count in ``fused_mha_fwd.launches``
    and ``fused_mha_bwd.launches``.
    """
    return _FusedMHA.apply(q, k, v, mask, num_heads, scale)
