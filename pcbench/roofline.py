"""Operations, bytes and peaks: the yardstick of every roofline and MFU.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity): bf16
989 TFLOP/s, TF32 495 TFLOP/s (the fastest tensor path that takes f32
inputs, so an f32 or 3xTF32 kernel can never read above its peak), HBM
3.35 TB/s.  No exp or special-function rate is used: it is no published
peak.

FLOPs follow the closed forms of the paper's Set Transformer
(``Code/models.py:13-44``, ``set_transformer-master/modules.py``): one
multiply-add is 2 FLOPs; biases, softmax and other elementwise work are
left out.  The counts describe the work, not an implementation: a kernel
that fuses or reorders the same function reads against the same count.
"""
from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12


def dense_flops(n_rows: int, d_in: int, d_out: int) -> int:
    return 2 * n_rows * d_in * d_out


def mab_flops(n_q: int, n_kv: int, dim_q: int, dim_k: int, dim_v: int) -> int:
    """One MAB: the q, k, v projections, QKᵀ and A·V over all heads, and
    the output projection."""
    proj = dense_flops(n_q, dim_q, dim_v) + 2 * dense_flops(n_kv, dim_k, dim_v)
    attn = 2 * (2 * n_q * n_kv * dim_v)
    return proj + attn + dense_flops(n_q, dim_v, dim_v)


def isab_flops(n: int, dim_in: int, dim_out: int, num_inds: int) -> int:
    return (mab_flops(num_inds, n, dim_out, dim_in, dim_out)
            + mab_flops(n, num_inds, dim_in, dim_out, dim_out))


def pma_flops(n: int, dim: int, num_seeds: int) -> int:
    return mab_flops(num_seeds, n, dim, dim, dim)


def st_flops(n_points: int, dim_input: int, dim_hidden: int, num_inds: int,
             dim_output: int, num_outputs: int = 1) -> int:
    """The ST classifier on one cloud of ``n_points``: ISAB, ISAB, PMA,
    Linear."""
    return (isab_flops(n_points, dim_input, dim_hidden, num_inds)
            + isab_flops(n_points, dim_hidden, dim_hidden, num_inds)
            + pma_flops(n_points, dim_hidden, num_outputs)
            + dense_flops(num_outputs, dim_hidden, dim_output))


def st_attention_pairs(n_points: int, num_inds: int, num_outputs: int = 1) -> int:
    """(query, key) pairs of the ST's five attends on one cloud of
    ``n_points`` valid points: each ISAB's MAB0 (inducing points over the
    points) and MAB1 (points over the inducing points), and the PMA."""
    return 4 * n_points * num_inds + num_outputs * n_points


def attention_fwd_flops(pairs: int, dim: int) -> int:
    """QKᵀ and A·V over ``pairs`` (query, key) pairs at width ``dim`` (all
    heads together)."""
    return 2 * (2 * pairs * dim)


def attention_bwd_flops(pairs: int, dim: int) -> int:
    """The backward of :func:`attention_fwd_flops`: dV, dP, dQ, dK, and the
    recomputed scores, 2.5 times the forward."""
    return 5 * (2 * pairs * dim)


def st_attention_bytes(n: int, n_points: int, num_inds: int, dim: int,
                       num_outputs: int = 1, backward: bool = False) -> int:
    """f32 bytes the five attends move at least, once each, over ``n``
    clouds: Q, K, V and O (forward), and also dO, the row log-sum-exps,
    dQ, dK and dV (backward)."""
    rows = {  # (query rows, key rows) of each attend
        "isab.mab0": (num_inds, n_points), "isab.mab1": (n_points, num_inds)}
    per = 0
    for nq, nk in list(rows.values()) * 2 + [(num_outputs, n_points)]:
        fwd = (2 * nq + 2 * nk) * dim * 4           # Q, O; K, V
        if backward:
            per += fwd + (2 * nq + 2 * nk) * dim * 4 + nq * 4  # dO, dQ; dK, dV; lse
        else:
            per += fwd
    return n * per


def extract_bytes(wave_samples: int, clouds: int, top_k: int,
                  value_bytes: int = 2, index_bytes: int = 4) -> int:
    """The least bytes of featurize + select: each f32 wave sample read
    once, and each selected value and its index written once (a fusion of
    the two kernels keeps the same count)."""
    return wave_samples * 4 + clouds * top_k * (value_bytes + index_bytes)


def roofline_s(flops: float, nbytes: float, peak: str) -> float:
    """The least seconds the card could take: the larger of operations
    over ``peak`` and bytes over the HBM rate."""
    return max(flops / PEAK_FLOPS[peak], nbytes / HBM_BYTES_PER_S)


def share_pct(bound_s: float, measured_s: float):
    """``bound_s`` over ``measured_s`` in percent; None where nothing was
    measured."""
    if not measured_s or measured_s <= 0:
        return None
    return 100.0 * bound_s / measured_s
