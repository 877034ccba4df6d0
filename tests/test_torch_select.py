"""Exact per-chunk top-K: the port's plain version == the JAX Pallas kernel
(interpret mode) bit for bit.  Kernel K2 is held against the plain version
in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcaudio.ops.kernels.select import exact_topk_chunks as jax_topk
from pcaudio_torch.ops.kernels.select import exact_topk_chunks_plain
from pcaudio_torch.probes.clips import negzero_grid


def _mags(N, F, kind, seed=0):
    """Non-negative [N, 10, F] grids; "ties" quantises to 16 levels so the
    K-th value is shared by many entries.  No subnormal values: the JAX
    kernel's threshold search stops at 2^-126.  "negzero" is the tie grid
    with 99 % of its entries zeroed, half of those as -0.0, so that the
    top K reaches into the zeros and -0.0 must tie with 0.0."""
    if kind == "negzero":
        return negzero_grid(N, F, seed)
    rng = np.random.default_rng(seed)
    m = np.abs(rng.standard_normal((N, 10, F))).astype(np.float32)
    if kind == "ties":
        m = np.floor(m * 5.0).clip(0, 15).astype(np.float32) / 4.0
    return m


@pytest.mark.parametrize("K,F", [(128, 512), (64, 512), (128, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "ties", "negzero"])
def test_plain_select_matches_jax_kernel(K, F, dtype, kind):
    m = _mags(3, F, kind)
    jm = jnp.asarray(m).astype(dtype)
    tm = torch.from_numpy(m).to(getattr(torch, dtype))
    rv, ri = jax_topk(jm, K)
    gv, gi = exact_topk_chunks_plain(tm, K)
    # identical sets in identical (ascending flat-index) order, same values
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    assert (np.diff(gi.numpy(), axis=1) > 0).all()
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32


def test_plain_select_all_zero_chunk_takes_first_k():
    v, i = exact_topk_chunks_plain(torch.zeros(2, 10, 512), 128)
    np.testing.assert_array_equal(i.numpy(), np.tile(np.arange(128), (2, 1)))
    assert (v == 0).all()
