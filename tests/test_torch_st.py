"""The port's ST (pcaudio_torch) == the JAX ST.  Inputs come from numpy
seeds; JAX stays on the CPU.  Kernel K1 is held against the plain version
in test_torch_cuda.py."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcaudio.checkpoint import st_params
from pcaudio.checkpoint.torch_export import st_state_dict
from pcaudio.nn import ST as JaxST
from pcaudio.ops.kernels.fused_st import fused_st_forward as jax_fused_st
from pcaudio_torch.checkpoint import load_reference_pth, st_state_dict_from_jax
from pcaudio_torch.nn import ST
from pcaudio_torch.ops.kernels.fused_st import fused_st_forward

FST_PTH = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                       "roundtrip", "FST_roundtrip_net.pth")

# f32 logits: the docs/ACCURACY.md bar for f32 parity between the stacks
F32_ATOL = 1e-4


def _pair(din, dim, inds, heads, seed=0):
    """A JAX ST with numpy-seeded params and the port ST carrying the same
    weights through st_state_dict_from_jax."""
    tm = ST(dim_input=din, dim_output=10, num_inds=inds, dim_hidden=dim,
            num_heads=heads)
    rng = np.random.default_rng(seed)
    sd = {k: rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
          for k, v in tm.state_dict().items()}
    params = st_params(sd)
    tm.load_state_dict(st_state_dict_from_jax(params))
    jm = JaxST(dim_input=din, dim_output=10, num_inds=inds, dim_hidden=dim,
               num_heads=heads)
    return jm, params, tm.eval()


def _mask(pattern, B, K):
    if pattern == "full":
        return None
    if pattern == "all_masked":
        m = np.ones((B, K), bool)
        m[1] = False
        m[-1] = False
        return m
    counts = np.array([K, K - 5, 10, 3, 1, K // 2])[:B]
    return np.arange(K)[None, :] < counts[:, None]


@pytest.mark.parametrize("din,dim,inds,heads", [(3, 16, 8, 4), (3, 64, 64, 8)],
                         ids=["small", "full_3st"])
@pytest.mark.parametrize("pattern", ["full", "ragged", "all_masked"])
def test_st_matches_jax(din, dim, inds, heads, pattern):
    rng = np.random.default_rng(1)
    B, K = 6, 40
    jm, params, tm = _pair(din, dim, inds, heads)
    pts = rng.standard_normal((B, K, din)).astype(np.float32)
    mask = _mask(pattern, B, K)
    ref = np.asarray(jax.jit(jm.apply)(
        params, jnp.asarray(pts),
        mask=None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(pts),
                 None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == (B, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)


def test_converter_matches_torch_export():
    _, params, _ = _pair(3, 16, 8, 4)
    ref = st_state_dict(params, data_parallel_prefix=False)
    got = st_state_dict_from_jax(params)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    # and the port's module names are exactly the reference's
    tm = ST(dim_input=3, dim_output=10, num_inds=8, dim_hidden=16, num_heads=4)
    assert set(tm.state_dict()) == set(ref)


def test_fst_roundtrip_checkpoint_logits_match_jax():
    sd = load_reference_pth(FST_PTH)
    tm = ST(dim_input=2, dim_output=10, num_inds=64, dim_hidden=64,
            num_heads=8).eval()
    tm.load_state_dict(sd)
    params = st_params({k: v.numpy() for k, v in sd.items()})
    jm = JaxST(dim_input=2, dim_output=10, num_inds=64, dim_hidden=64,
               num_heads=8)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1.0, 1.0, (8, 128, 2)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(pts)))
    with torch.no_grad():
        got = tm(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)


def test_fused_st_plain_matches_jax_kernel():
    """The port's fused_st_forward on CPU (its plain version, f32) vs the
    JAX Pallas kernel in interpret mode, which runs bf16 matmuls and the
    serving fast softmax: the JAX test's own bf16 bar, 3e-2
    (tests/test_fused_st.py)."""
    rng = np.random.default_rng(3)
    jm, params, tm = _pair(3, 16, 8, 4, seed=1)
    pts = rng.standard_normal((16, 32, 3)).astype(np.float32)
    ref = np.asarray(jax_fused_st(params, jnp.asarray(pts), None, num_heads=4,
                                  block_b=16))
    got = fused_st_forward(tm, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-2, rtol=3e-2)
