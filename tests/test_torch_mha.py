"""K4 trainable masked attention: the port's fused_mha on CPU tensors (its
plain pair) == the JAX Pallas kernel (interpret mode) and the JAX XLA
attention, forward and gradients; its backward formula == autograd; and a
float64 gradcheck of the autograd.Function.  The CUDA kernels are held
against the plain pair in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcaudio.nn.attention import masked_softmax as jax_masked_softmax
from pcaudio.ops.kernels.mha import fused_mha as jax_fused_mha
from pcaudio_torch.ops.kernels.mha import (
    fused_mha, fused_mha_bwd, fused_mha_bwd_plain, fused_mha_fwd,
    fused_mha_plain)

B, H, DV = 5, 4, 16
SCALE = 1.0 / np.sqrt(DV)
# tests/test_fused_mha_grad.py's cases: (N, M, mask pattern, query tile)
CASES = [(33, 8, "ragged", 256), (8, 40, "ragged", 256), (70, 16, "full", 32)]
IDS = ["mab1_dir", "mab0_dir_masked", "multi_tile"]


def _xla_mha(q, k, v, mask, h, scale):
    """tests/test_fused_mha_grad.py::_xla_mha: masked einsum-softmax."""
    Bq, N, dv = q.shape
    M = k.shape[1]
    dh = dv // h
    logits = jnp.einsum("bnhd,bmhd->bhnm", q.reshape(Bq, N, h, dh),
                        k.reshape(Bq, M, h, dh)) * scale
    mb = None if mask is None else mask[:, None, None, :]
    attn = jax_masked_softmax(logits, mb, axis=-1)
    return jnp.einsum("bhnm,bmhd->bnhd", attn,
                      v.reshape(Bq, M, h, dh)).reshape(Bq, N, dv)


def _inputs(N, M, pattern, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal(s).astype(np.float32)
                    for s in ((B, N, DV), (B, M, DV), (B, M, DV), (B, N, DV)))
    mask = None
    if pattern == "ragged":   # includes an all-masked sample
        counts = np.array([M, M - 3, M // 2, 1, 0])
        mask = np.arange(M)[None, :] < counts[:, None]
    return q, k, v, mask, cot


def _port(q, k, v, mask, cot):
    """Output and dq, dk, dv of sum(fused_mha(...) * cot) on CPU tensors."""
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    out = fused_mha(*leaves, tmask, H, SCALE)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


def _jax(fn, q, k, v, mask, cot):
    """Output and the vjp of ``cot``, in one jitted call."""
    jmask = None if mask is None else jnp.asarray(mask)

    @jax.jit
    def run(a, b, c, g):
        out, vjp = jax.vjp(lambda *x: fn(*x, jmask), a, b, c)
        return out, vjp(g)

    out, grads = run(*(jnp.asarray(x) for x in (q, k, v, cot)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("N,M,pattern,tile", CASES, ids=IDS)
def test_port_matches_jax_kernel(N, M, pattern, tile):
    """Against the Pallas kernel (bf16 operands on the MXU, run here in
    interpret mode): that file's own bars, 2e-2 forward and 3e-2 grads."""
    q, k, v, mask, cot = _inputs(N, M, pattern)
    out, grads = _port(q, k, v, mask, cot)
    ref, rgrads = _jax(lambda a, b, c, m: jax_fused_mha(
        a, b, c, m, num_heads=H, scale=SCALE, block_b=2, tile_n=tile),
        q, k, v, mask, cot)
    np.testing.assert_allclose(out, ref, atol=2e-2, rtol=2e-2)
    for g, r, name in zip(grads, rgrads, "qkv"):
        np.testing.assert_allclose(g, r, atol=3e-2, rtol=3e-2,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("N,M,pattern,tile", CASES, ids=IDS)
def test_port_matches_jax_xla_attention(N, M, pattern, tile):
    """Against the JAX XLA attention in f32: 1e-5."""
    q, k, v, mask, cot = _inputs(N, M, pattern, seed=1)
    out, grads = _port(q, k, v, mask, cot)
    ref, rgrads = _jax(lambda a, b, c, m: _xla_mha(a, b, c, m, H, SCALE),
                       q, k, v, mask, cot)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    for g, r, name in zip(grads, rgrads, "qkv"):
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=0, err_msg=f"d{name}")
    if mask is not None:   # the all-masked sample: zeros, not NaN
        assert not out[4].any() and not any(g[4].any() for g in grads)


@pytest.mark.parametrize("N,M,pattern,tile", CASES, ids=IDS)
def test_bwd_formula_matches_autograd(N, M, pattern, tile):
    """fused_mha_bwd_plain (the formula the CUDA backward implements) ==
    autograd through fused_mha_plain."""
    q, k, v, mask, cot = _inputs(N, M, pattern, seed=2)
    leaves = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    g = torch.from_numpy(cot).double()
    (fused_mha_plain(*leaves, tmask, H, SCALE) * g).sum().backward()
    got = fused_mha_bwd_plain(*(x.detach() for x in leaves), tmask, g, H, SCALE)
    for a, x, name in zip(got, leaves, "qkv"):
        torch.testing.assert_close(a, x.grad, atol=1e-12, rtol=1e-10,
                                   msg=f"d{name}")


@pytest.mark.parametrize("pattern", ["full", "ragged"])
def test_function_gradcheck_float64(pattern):
    N, M = 6, 7
    q, k, v, mask, _ = _inputs(N, M, pattern, seed=3)
    leaves = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    assert torch.autograd.gradcheck(
        lambda a, b, c: fused_mha(a, b, c, tmask, H, SCALE), leaves)


def test_cpu_tensors_never_launch_and_bad_shapes_raise():
    q, k, v, mask, _ = _inputs(8, 40, "ragged")
    counts = (fused_mha_fwd.launches, fused_mha_bwd.launches)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fused_mha(*leaves, torch.from_numpy(mask), H, SCALE).sum().backward()
    assert (fused_mha_fwd.launches, fused_mha_bwd.launches) == counts
    with pytest.raises(ValueError, match="divisible"):
        fused_mha(*leaves, None, 3, SCALE)
    with pytest.raises(ValueError, match="mask"):
        fused_mha(*leaves, torch.ones(B, 3, dtype=torch.bool), H, SCALE)
    with pytest.raises(ValueError, match="CUDA"):   # the kernels' own check
        fused_mha_fwd(*leaves, None, H, SCALE)
