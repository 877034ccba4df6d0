"""The whole ST forward in one kernel: K1 (``csrc/fused_st.cu``, the port of
``pcaudio/ops/kernels/fused_st.py::fused_st_forward``) and its plain
PyTorch version, the port's ``ST`` module itself.

ISAB → ISAB → PMA(1 seed) → Linear, one thread block per cloud, every
intermediate in shared memory.  The softmax is the exact max-subtract one
with v4's mask semantics (a fully masked cloud attends to nothing), so one
kernel serves both the mask-free serving call and the masked one.
"""
from __future__ import annotations

from typing import Optional

import torch

from pcaudio_torch.nn import ST
from pcaudio_torch.ops.kernels import _build

# widths the kernel is compiled for (the shipped FST/3ST checkpoints)
DIM_HIDDEN = 64
NUM_HEADS = 8
MAX_POINTS = 128
MAX_INDS = 128
MAX_CLASSES = 256


def _check(model: ST, points: torch.Tensor, mask: Optional[torch.Tensor]):
    if model.num_outputs != 1:
        raise ValueError("fused ST forward needs num_outputs == 1")
    if points.dim() != 3:
        raise ValueError(f"points [N, K, din] expected, got "
                         f"{tuple(points.shape)}")
    if mask is not None and mask.shape != points.shape[:2]:
        raise ValueError(f"mask {tuple(mask.shape)} does not match points "
                         f"{tuple(points.shape)}")


def fused_st_forward_plain(model: ST, points: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: the ``ST`` module in f32."""
    _check(model, points, mask)
    with torch.no_grad():
        return model(points.float(), mask).float()


def _packed_weights(model: ST, device) -> torch.Tensor:
    """One f32 buffer of every weight, in the order ``fused_st.cu`` reads
    them, linear weights transposed to ``[in, out]``.  The batch-invariant
    query projections of the inducing points and the seed are computed
    here.  Cached on the module, keyed by each parameter's storage and
    version counter, so ``load_state_dict`` or an optimizer step repacks."""
    params = list(model.parameters())
    key = (str(device),) + tuple((p.data_ptr(), p._version) for p in params)
    cached = getattr(model, "_fused_st_pack", None)
    if cached is not None and cached[0] == key:
        return cached[1]

    def mab(m, with_q):
        out = [m.fc_q.weight.T, m.fc_q.bias] if with_q else []
        return out + [m.fc_k.weight.T, m.fc_k.bias, m.fc_v.weight.T,
                      m.fc_v.bias, m.fc_o.weight.T, m.fc_o.bias]

    with torch.no_grad():
        parts = []
        for isab in model.enc:
            # iq, MAB0 k/v/o, then MAB1 q/k/v/o
            parts += [isab.mab0.fc_q(isab.I[0])] + mab(isab.mab0, False)
            parts += mab(isab.mab1, True)
        pma = model.dec[0]
        parts += [pma.mab.fc_q(pma.S[0])] + mab(pma.mab, False)
        parts += [model.dec[1].weight.T, model.dec[1].bias]
        buf = torch.cat([p.detach().float().reshape(-1) for p in parts])
        buf = buf.to(device).contiguous()
    model._fused_st_pack = (key, buf)
    return buf


def fused_st_forward(model: ST, points: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``points [N, K, din]`` (f32 or bf16), ``mask [N, K]`` bool or None →
    logits ``[N, ncls]`` f32.

    CPU tensors take :func:`fused_st_forward_plain`; CUDA tensors the
    kernel, which needs ``dim_hidden`` 64, 8 heads, ``din`` 2 or 3,
    ``K ≤ 128`` and ``num_inds ≤ 128``.
    """
    if points.device.type == "cpu":
        return fused_st_forward_plain(model, points, mask)
    _check(model, points, mask)
    N, K, din = points.shape
    isab = model.enc[0]
    M, dv = isab.I.shape[1], isab.I.shape[2]
    ncls = model.dec[1].out_features
    if (dv, model.num_heads) != (DIM_HIDDEN, NUM_HEADS) or din not in (2, 3):
        raise ValueError(f"kernel built for dim_hidden={DIM_HIDDEN}, "
                         f"num_heads={NUM_HEADS}, din 2 or 3; got {dv}, "
                         f"{model.num_heads}, {din}")
    if not (1 <= K <= MAX_POINTS and 1 <= M <= MAX_INDS
            and 1 <= ncls <= MAX_CLASSES):
        raise ValueError(f"K={K}, num_inds={M}, classes={ncls} outside the "
                         f"kernel's limits {MAX_POINTS}/{MAX_INDS}/{MAX_CLASSES}")
    if points.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"points must be float32 or bfloat16, got "
                        f"{points.dtype}")
    if not (points.is_cuda and points.is_contiguous()):
        raise ValueError("points must be a contiguous CUDA tensor")
    if mask is not None:
        mask = mask.to(device=points.device, dtype=torch.bool).contiguous()
    w = _packed_weights(model, points.device)
    out = torch.empty((N, ncls), dtype=torch.float32, device=points.device)
    launch_packed(points, mask, w, out, M)
    return out


def launch_packed(points: torch.Tensor, mask: Optional[torch.Tensor],
                  w: torch.Tensor, out: torch.Tensor, num_inds: int) -> None:
    """One launch of K1 on checked operands: ``points [N, K, din]``
    contiguous on the card, ``mask`` contiguous bool or None, ``w`` from
    :func:`_packed_weights`, ``out [N, ncls]`` f32.  Counts as a launch of
    :func:`fused_st_forward`."""
    N, K, din = points.shape
    _build.launch("pcaudio_fused_st", points.data_ptr(),
                  int(points.dtype == torch.bfloat16),
                  None if mask is None else mask.data_ptr(),
                  w.data_ptr(), w.numel(), out.data_ptr(), N, K, din, num_inds,
                  out.shape[1], _build.stream_of(points))
    fused_st_forward.launches += 1


fused_st_forward.launches = 0
