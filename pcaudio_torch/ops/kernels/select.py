"""Exact per-chunk top-K of non-negative magnitudes: kernel K2
(``csrc/select.cu``, the port of ``pcaudio/ops/kernels/select.py::
exact_topk_chunks``) and its plain PyTorch version.

The selected set is exactly ``lax.top_k``'s over the row-major flattening
of each chunk: ties go to the first in flat order.  Output comes in
ascending flat-index order, as the JAX kernel returns it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from pcaudio_torch.ops.kernels import _build

# the kernel keeps a chunk's Nt·F values (4 bytes each in f32) in one block's
# shared memory beside 1.6 KB of its own, and counts a digit's keys in 16
# bits (csrc/select.cu::kMaxChunk; a test runs the kernel at this size)
MAX_CHUNK = (227 * 1024 - 2048) // 4


def max_k(chunk_len: int) -> int:
    """The largest K the kernel takes for chunks of ``chunk_len`` = Nt·F
    values: every value, while the chunk fits in shared memory (57,600
    values), else 0 (no K)."""
    return chunk_len if 1 <= chunk_len <= MAX_CHUNK else 0


def _check(mags: torch.Tensor, K: int) -> None:
    if mags.dim() != 3:
        raise ValueError(f"mags [N, Nt, F] expected, got {tuple(mags.shape)}")
    if mags.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mags must be float32 or bfloat16, got {mags.dtype}")
    L = mags.shape[1] * mags.shape[2]
    if L > MAX_CHUNK:
        raise ValueError(f"a chunk of Nt·F = {L} values exceeds the kernel's "
                         f"{MAX_CHUNK} (its shared memory)")
    if not 1 <= K <= max_k(L):
        raise ValueError(f"K={K} outside [1, Nt·F = {L}]")


def exact_topk_chunks_plain(mags: torch.Tensor, K: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: a stable descending sort of each flattened chunk (equal
    values keep flat order, unlike ``torch.topk``, whose tie order is
    unspecified on CUDA), the first K, re-sorted by index.  The sort key is
    ``value + 0.0``, which is the value except that -0.0 becomes 0.0, so
    -0.0 ties with 0.0 whatever the sort's treatment of signed zeros."""
    _check(mags, K)
    flat = mags.reshape(mags.shape[0], -1).float()
    order = torch.sort(flat + 0.0, dim=-1, descending=True, stable=True).indices
    idx = order[:, :K].sort(dim=-1).values
    return flat.gather(1, idx), idx.to(torch.int32)


def exact_topk_chunks(mags: torch.Tensor, K: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mags [N, Nt, F]`` non-negative (f32 or bf16) → ``(values [N, K]
    f32, flat_indices [N, K] int32)`` in ascending flat-index order.

    Values must be non-negative (squared magnitudes are): the kernel orders
    values by their IEEE bit patterns with the sign cleared, so -0.0 is
    taken as 0.0 (it ties with 0.0 in flat order), as in the JAX kernel; a
    selected -0.0 comes back as -0.0.  CPU tensors take
    :func:`exact_topk_chunks_plain`; CUDA tensors the kernel.
    """
    if mags.device.type == "cpu":
        return exact_topk_chunks_plain(mags, K)
    _check(mags, K)
    if not (mags.is_cuda and mags.is_contiguous()):
        raise ValueError("mags must be a contiguous CUDA tensor")
    N, Nt, F = mags.shape
    vals = torch.empty((N, K), dtype=torch.float32, device=mags.device)
    idx = torch.empty((N, K), dtype=torch.int32, device=mags.device)
    _build.launch("pcaudio_topk_chunks", mags.data_ptr(),
                  int(mags.dtype == torch.bfloat16), vals.data_ptr(),
                  idx.data_ptr(), N, Nt * F, K, _build.stream_of(mags))
    exact_topk_chunks.launches += 1
    return vals, idx


exact_topk_chunks.launches = 0
