"""Approximate per-row top-K by window maxima: kernel K2a
(``csrc/approx_select.cu``) and its plain PyTorch version.

The counterpart of ``lax.approx_max_k``, which the JAX package's serving
pipeline calls with ``extraction="approx"``; on the TPU, XLA lowers it to
its ApproxTopK.  No Pallas kernel stands behind it, so K2a replaces an XLA
operation.  What it computes is XLA's reduction plan, not a recall: the N
keys of a row are max-reduced into M windows of 2^r keys
(:func:`approx_topk_plan`, from the recall target), and the exact top K of
the M window maxima is taken.

* Window w holds the keys w, w + M, w + 2M, ... of the row padded to
  2^r · M with -inf: the elementwise max of its 2^r consecutive slabs of M
  keys.  No run can show which assignment the TPU uses; the strided one is
  the port's choice.
* A tie inside a window goes to the lower flat index (the lower slab), a
  tie between window maxima to the lower window; -0.0 ties with 0.0.
* Keys may be negative (the ``"xla"`` path selects on log-magnitudes),
  f32 or bf16, and must not be NaN.
* Output: ``(values [R, K] f32, flat indices [R, K] int32)`` in ascending
  flat-index order, as K2 (``select.py``) returns them.  At r = 0 the set
  is :func:`~pcaudio_torch.ops.kernels.select.exact_topk_chunks_plain`'s.

``approx_recall`` is XLA's target for keys at random positions.  Audio
grids are not that: loud bins repeat across frames and neighbouring bins
and collide in windows, so the recall they get is measured (PERF.md), not
assumed.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from pcaudio_torch.ops.kernels import _build
from pcaudio_torch.ops.kernels.select import MAX_CHUNK, exact_topk_chunks_plain

# the kernel holds a row's window maxima in one block's shared memory and
# counts them in 16-bit bins, as K2 does (csrc/select.cuh::kMaxChunk)
MAX_ROW = MAX_CHUNK
_LANES = 128   # XLA rounds the window count up to the TPU's lane width


def approx_topk_plan(N: int, K: int, recall: float) -> Tuple[int, int]:
    """``(M, r)``: M windows of 2^r keys for the top K of N keys at the
    recall target ``recall``; r = 0 is an exact top-K over ``M = N``.

    A copy of XLA's ``ApproxTopKReductionOutputSize`` for operands of rank
    2 or more (the JAX package's keys are ``[B, C, N]``): m = min(max(⌊(1 −
    K) / ln(recall)⌋, 128), N), r = ⌊log2(N / m)⌋, M = ⌈⌈N / 128⌉ / 2^r⌉ ·
    128; recall 1.0 is exact; K = 1 takes r = ⌈log2 ⌈N / 128⌉⌉ and M = 128
    at any recall (N ≤ 128: exact)."""
    if not 0.0 < recall <= 1.0:
        raise ValueError(f"recall must lie in (0, 1], got {recall}")
    if not 1 <= K <= N:
        raise ValueError(f"K={K} outside [1, N = {N}]")
    tiles = -(-N // _LANES)
    if K == 1:
        return (N, 0) if N <= _LANES else (_LANES, (tiles - 1).bit_length())
    if recall == 1.0:
        return N, 0
    m = min(max(math.floor((1 - K) / math.log(recall)), _LANES), N)
    r = (N // m).bit_length() - 1
    if r == 0:
        return N, 0
    M = -(-tiles // (1 << r)) * _LANES
    if M < K:
        raise ValueError(f"recall {recall} leaves {M} windows for the top {K} "
                         f"of {N} keys")
    return M, r


def _check(keys: torch.Tensor, K: int, recall: float) -> Tuple[int, int]:
    if keys.dim() != 2:
        raise ValueError(f"keys [R, N] expected, got {tuple(keys.shape)}")
    if keys.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"keys must be float32 or bfloat16, got {keys.dtype}")
    N = keys.shape[1]
    if N > MAX_ROW:
        raise ValueError(f"a row of {N} keys exceeds the kernel's {MAX_ROW}")
    return approx_topk_plan(N, K, recall)


def approx_topk_chunks_plain(keys: torch.Tensor, K: int, recall: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the window maxima by a walk over the slabs (a later
    slab replaces a window's maximum only when its key is larger, so a tie
    stays with the lower slab; the comparison key is ``value + 0.0``, so
    -0.0 ties with 0.0), K2's plain select over them, the winners' flat
    indices sorted, and their values read from ``keys``."""
    M, r = _check(keys, K, recall)
    R, N = keys.shape
    if r == 0:
        return exact_topk_chunks_plain(keys.reshape(R, 1, N), K)
    S = 1 << r
    x = F.pad(keys.float(), (0, S * M - N), value=-math.inf).view(R, S, M) + 0.0
    best, slab = x[:, 0], torch.zeros(R, M, dtype=torch.long, device=keys.device)
    for s in range(1, S):
        up = x[:, s] > best
        best = torch.where(up, x[:, s], best)
        slab = torch.where(up, s, slab)
    _, win = exact_topk_chunks_plain(best.view(R, 1, M), K)
    win = win.long()
    idx = (slab.gather(1, win) * M + win).sort(dim=1).values
    return keys.float().gather(1, idx), idx.to(torch.int32)


def approx_topk_chunks(keys: torch.Tensor, K: int, recall: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``keys [R, N]`` (f32 or bf16) → ``(values [R, K] f32, flat_indices
    [R, K] int32)`` in ascending flat-index order: the exact top K of
    :func:`approx_topk_plan`'s M window maxima of each row.  CPU tensors
    take :func:`approx_topk_chunks_plain`; CUDA tensors kernel K2a, which
    refuses (``RuntimeError``) a row whose window maxima, their slabs and
    the K winners exceed a block's shared memory."""
    if keys.device.type == "cpu":
        return approx_topk_chunks_plain(keys, K, recall)
    M, r = _check(keys, K, recall)
    if not (keys.is_cuda and keys.is_contiguous()):
        raise ValueError("keys must be a contiguous CUDA tensor")
    R, N = keys.shape
    vals = torch.empty((R, K), dtype=torch.float32, device=keys.device)
    idx = torch.empty((R, K), dtype=torch.int32, device=keys.device)
    _build.launch("pcaudio_approx_topk", keys.data_ptr(),
                  int(keys.dtype == torch.bfloat16), vals.data_ptr(),
                  idx.data_ptr(), R, N, M, r, K, _build.stream_of(keys))
    approx_topk_chunks.launches += 1
    return vals, idx


approx_topk_chunks.launches = 0
