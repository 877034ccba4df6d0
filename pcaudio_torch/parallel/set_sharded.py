"""The ST forward with its point axis sharded over the mesh's ``set`` axis
and explicit collectives (counterpart of
``pcaudio/parallel/set_sharded.py``).

Each rank holds ``[B_loc, N_loc, d]`` points: its data shard's clouds and
its set shard of their points.  Only the ``m`` inducing / seed vectors cross
set shards:

  * **MAB0 and PMA** (replicated queries attend over the sharded points):
    K4's forward on the local keys gives ``(out_r, lse_r)``; the shards
    combine them with one MAX all-reduce of the local ``lse`` and two SUM
    all-reduces (the weighted outputs, the weights) over the ``set`` group,
    the same function as JAX's ``exp(lg − pmax)`` split.  The backward
    SUM-all-reduces the incoming gradient over the group (the transpose of
    the forward's sum) and runs K4's backward on the local keys with the
    combined ``out`` and ``lse``: it reads ``out`` only for ``rowsum(g ⊙
    out)`` and ``lse`` only for ``exp(S − lse)``, so each shard gets its
    keys' exact gradients and its share of the queries'.
  * **MAB1** (the points attend to the replicated summaries): local, K4 as
    it is.
  * projections, rFF, the final Linear: pointwise, local.

So a forward issues exactly 3 MAX and 6 SUM all-reduces over the ``set``
group, and a backward 3 SUMs.  The math is the port's ``ST`` (scale
1/√dim_V, projected-Q residual, single-ReLU rFF).  CUDA tensors run K4
(``ops/kernels/mha.py``), CPU tensors its plain pair.

Gradients: a rank's parameter gradients sum, over its ``set`` group, to
``n_set`` times the true gradient of its data shard's loss (a replicated
path carries its share on every rank, a sharded path carries the summed
incoming gradient), so averaging them over all ranks (DDP over the world)
gives the gradient of the global batch's mean loss.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch import nn

from pcaudio_torch.ops.kernels.mha import (
    fused_mha, fused_mha_bwd, fused_mha_bwd_plain, fused_mha_fwd,
    fused_mha_fwd_plain, fused_mha_plain)
from pcaudio_torch.parallel.mesh import Mesh


def _combine(out, lse, num_heads, group):
    """The attention over every shard's keys from each shard's ``(out [B,
    N, dv], lse [B, h, N])`` (+inf: no valid key in the shard): one MAX and
    two SUM all-reduces over ``group``.  Returns the combined pair, ``lse``
    +inf where no shard has a valid key (K4's convention)."""
    B, N, dv = out.shape
    lse = lse.masked_fill(lse == float("inf"), float("-inf"))
    top = lse.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    top = top.masked_fill(top == float("-inf"), 0.0)   # no valid key anywhere
    w = torch.exp(lse - top)                            # [B, h, N]
    num = (out.view(B, N, num_heads, -1) * w.transpose(1, 2)[..., None]).reshape(B, N, dv)
    dist.all_reduce(num, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    tiny = torch.finfo(out.dtype).tiny
    out = (num.view(B, N, num_heads, -1)
           / w.clamp_min(tiny).transpose(1, 2)[..., None]).reshape(B, N, dv)
    lse = torch.where(w > 0, top + torch.log(w), float("inf"))
    return out, lse


class _ShardedKeysAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, num_heads, scale, group, plain):
        ctx.num_heads, ctx.scale, ctx.group, ctx.plain = num_heads, scale, group, plain
        fwd = fused_mha_fwd_plain if plain else fused_mha_fwd
        out, lse = _combine(*fwd(q, k, v, mask, num_heads, scale), num_heads, group)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        if ctx.plain:
            grads = fused_mha_bwd_plain(q, k, v, mask, g, ctx.num_heads, ctx.scale,
                                        out=out, lse=lse)
        else:
            grads = fused_mha_bwd(q, k, v, mask, out, lse, g, ctx.num_heads, ctx.scale)
        return (*grads, None, None, None, None, None)


def sharded_keys_attention(q, k, v, mask, num_heads: int, scale: float, *,
                           group, plain: bool = False) -> torch.Tensor:
    """``softmax(q·kᵀ·scale, mask)·v`` over the keys of every rank of
    ``group``, each rank holding its shard of ``k``, ``v`` and ``mask``
    and the same ``q``; differentiable in q, k and v (see the module's
    docstring).  ``plain`` runs K4's plain pair; otherwise CUDA tensors run
    K4 and CPU tensors its plain pair."""
    plain = plain or q.device.type == "cpu"
    return _ShardedKeysAttention.apply(q, k, v, mask, num_heads, scale, group, plain)


def set_sharded_st_forward(model, points: torch.Tensor, mask, mesh: Mesh, *,
                           plain: bool = False) -> torch.Tensor:
    """The port's ``ST`` forward with the point axis sharded over the mesh's
    ``set`` axis and the batch over ``data``.

    ``points [B_loc, N_loc, d]`` and ``mask [B_loc, N_loc]`` bool (or None:
    every point valid) are this rank's shard (``shard_batch(mesh, ...,
    shard_set_axis=True)``); returns the logits of its data shard, ``[B_loc,
    dim_output]`` (replicated over its set group).  ``plain=True`` runs K4's
    plain pair on any device (the reference the smoke run holds K4 to)."""
    keys = functools.partial(sharded_keys_attention, group=mesh.set_group,
                             plain=plain)
    local = fused_mha_plain if plain else fused_mha
    B = points.shape[0]
    x = points
    for isab in model.enc:
        H = isab.mab0(isab.I.expand(B, -1, -1), x, mask, attend=keys)
        x = isab.mab1(x, H, attend=local)
    pma, linear = model.dec
    out = linear(pma.mab(pma.S.expand(B, -1, -1), x, mask, attend=keys))
    return out[:, 0, :] if model.num_outputs == 1 else out


class SetShardedST(nn.Module):
    """``model`` (an ``ST``) run by :func:`set_sharded_st_forward` over
    ``mesh``: a module, so that ``DistributedDataParallel`` can wrap it."""

    def __init__(self, model: nn.Module, mesh: Mesh):
        super().__init__()
        self.model = model
        self.mesh = mesh

    def forward(self, points, mask=None):
        return set_sharded_st_forward(self.model, points, mask, self.mesh)
