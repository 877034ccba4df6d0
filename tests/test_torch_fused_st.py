"""K1's plain version (``pcaudio_torch.ops.kernels.fused_st``) against the
JAX fused ST kernel in interpret mode and against the f32 ST; its packed
weights; the K1 and K2 wrappers' limits.  The kernels themselves are held
against these plain versions on the card (test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcaudio.checkpoint import st_params
from pcaudio.ops.kernels.fused_st import fused_st_forward as jax_fused_st
from pcaudio_torch.checkpoint import st_state_dict_from_jax
from pcaudio_torch.nn import ST
from pcaudio_torch.ops.kernels import fused_st as k1
from pcaudio_torch.ops.kernels import select as k2

# the JAX tests' bars for the bf16 fused ST (tests/test_fused_st.py), atol =
# rtol: 3e-2 kernel against kernel, 5e-2 against the f32 model
JAX_TOL = 3e-2
F32_TOL = 5e-2

WIDTHS = {"small": (3, 16, 8, 4), "full_3st": (3, 64, 64, 8)}


def _pair(din, dim, inds, heads, seed=0):
    """The port ST with weights U(±1/√fan_in) from a numpy seed, and the
    JAX params carrying the same weights."""
    tm = ST(dim_input=din, dim_output=10, num_inds=inds, dim_hidden=dim,
            num_heads=heads)
    rng = np.random.default_rng(seed)
    sd = {k: (rng.uniform(-1, 1, v.shape) / np.sqrt(v.shape[-1])).astype(np.float32)
          for k, v in tm.state_dict().items()}
    params = st_params(sd)
    tm.load_state_dict(st_state_dict_from_jax(params))
    return params, tm.eval()


def _mask(pattern, B, K):
    if pattern == "full":
        return None
    counts = np.array([K, K - 5, 10, 3, 1, K // 2, 0, K - 1])[:B]
    if pattern == "all_masked":
        counts[:] = 0
        counts[0] = K
    return np.arange(K)[None, :] < counts[:, None]


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("pattern", ["full", "ragged", "all_masked"])
def test_plain_matches_jax_v4(width, pattern):
    """v4, the masked kernel with the exact softmax, every cloud padded and
    masked as the plain version's."""
    din, dim, inds, heads = WIDTHS[width]
    params, tm = _pair(din, dim, inds, heads)
    rng = np.random.default_rng(1)
    B, K = 8, 40
    pts = rng.standard_normal((B, K, din)).astype(np.float32)
    mask = _mask(pattern, B, K)
    ref = np.asarray(jax_fused_st(
        params, jnp.asarray(pts), None if mask is None else jnp.asarray(mask),
        num_heads=heads, block_b=8, variant="v4", fast_softmax=False))
    got = k1.fused_st_forward_plain(
        tm, torch.from_numpy(pts),
        None if mask is None else torch.from_numpy(mask)).numpy()
    print(f"{width} {pattern}: max |plain - JAX v4| {np.abs(got - ref).max():.3e}")
    assert got.shape == (B, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=JAX_TOL, rtol=JAX_TOL)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_plain_matches_jax_v6_mask_free(width):
    """v6, the serving kernel (pair-packed, clipped exp), mask-free."""
    din, dim, inds, heads = WIDTHS[width]
    params, tm = _pair(din, dim, inds, heads, seed=2)
    pts = np.random.default_rng(3).standard_normal((16, 32, din)).astype(np.float32)
    ref = np.asarray(jax_fused_st(params, jnp.asarray(pts), None,
                                  num_heads=heads, block_b=16))
    got = k1.fused_st_forward_plain(tm, torch.from_numpy(pts)).numpy()
    print(f"{width}: max |plain - JAX v6| {np.abs(got - ref).max():.3e}")
    np.testing.assert_allclose(got, ref, atol=JAX_TOL, rtol=JAX_TOL)


@pytest.mark.parametrize("din,K,pattern", [(3, 17, "ragged"), (3, 128, "full"),
                                           (2, 256, "all_masked"), (2, 1025, "ragged")])
def test_plain_matches_f32_st(din, K, pattern):
    """Full width, up to FST's 1025-point frames: the bf16 roundings keep the
    logits within the JAX tests' bar of the f32 model."""
    _, tm = _pair(din, 64, 64, 8, seed=din)
    rng = np.random.default_rng(4)
    B = 3
    pts = torch.from_numpy(rng.standard_normal((B, K, din)).astype(np.float32))
    mask = _mask(pattern, B, K)
    mask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        ref = tm(pts, mask)
    got = k1.fused_st_forward_plain(tm, pts, mask)
    print(f"din {din} K {K} {pattern}: max |plain - f32 ST| "
          f"{(got - ref).abs().max().item():.3e}")
    torch.testing.assert_close(got, ref, atol=F32_TOL, rtol=F32_TOL)
    # bf16 points are rounded once either way
    torch.testing.assert_close(k1.fused_st_forward_plain(tm, pts.bfloat16(), mask),
                               k1.fused_st_forward_plain(tm, pts, mask), atol=0, rtol=0)


def _unfragment(frags, k_in):
    """Inverse of the mma B-fragment order, from the PTX layout of
    m16n8k16's B operand: lane 4·(n % 8) + (k % 8) // 2 of column tile n // 8
    and k16 step k // 16 holds W[k, n] in its element (k % 2) + 2·((k % 16)
    // 8)."""
    steps = frags.shape[0]
    w = torch.empty(steps * 16, 64, dtype=frags.dtype)
    for k in range(steps * 16):
        for n in range(64):
            lane = 4 * (n % 8) + (k % 8) // 2
            w[k, n] = frags[k // 16, n // 8, lane, (k % 2) + 2 * ((k % 16) // 8)]
    assert not w[k_in:].any(), "rows past k_in must be 0"
    return w[:k_in]


@pytest.mark.parametrize("din,inds", [(3, 64), (2, 20)])
def test_packed_weights_unpack_to_parameters(din, inds):
    """The kernel's bf16 buffer holds every weight rounded to bf16 (in
    fragment order), the f32 buffer every bias exactly, and the inducing
    and seed queries are the f32 projections (also rounded in the bf16
    buffer)."""
    _, tm = _pair(din, 64, inds, 8, seed=5)
    wb, wf = k1._packed_weights(tm, "cpu")
    assert wb.dtype == torch.bfloat16 and wf.dtype == torch.float32
    bf = lambda t: t.detach().to(torch.bfloat16)
    ib, iff = 0, 0

    def take_b(n):
        nonlocal ib
        ib += n
        return wb[ib - n:ib]

    def take_f(n):
        nonlocal iff
        iff += n
        return wf[iff - n:iff]

    def frag(layer):
        k_in = layer.weight.shape[1]
        steps = -(-k_in // 16)
        got = _unfragment(take_b(steps * 1024).reshape(steps, 8, 32, 4), k_in)
        assert torch.equal(got, bf(layer.weight.T))

    with torch.no_grad():
        for isab in tm.enc:
            iq = isab.mab0.fc_q(isab.I[0])
            assert torch.equal(take_b(inds * 64), bf(iq).reshape(-1))
            layers = (isab.mab0.fc_k, isab.mab0.fc_v, isab.mab0.fc_o, isab.mab1.fc_q,
                      isab.mab1.fc_k, isab.mab1.fc_v, isab.mab1.fc_o)
            for layer in layers:
                frag(layer)
            assert torch.equal(take_f(inds * 64), iq.reshape(-1))
            for layer in layers:
                assert torch.equal(take_f(64), layer.bias)
        pma, dense = tm.dec[0].mab, tm.dec[1]
        sq = pma.fc_q(tm.dec[0].S[0])
        assert torch.equal(take_b(64), bf(sq).reshape(-1))
        frag(pma.fc_k)
        frag(pma.fc_v)
        assert torch.equal(take_b(64 * 64), bf(pma.fc_o.weight.T).reshape(-1))
        assert torch.equal(take_b(64 * 10), bf(dense.weight.T).reshape(-1))
        assert torch.equal(take_f(64), sq.reshape(-1))
        for layer in (pma.fc_k, pma.fc_v, pma.fc_o, dense):
            assert torch.equal(take_f(layer.bias.numel()), layer.bias)
    assert ib == wb.numel() and iff == wf.numel()


@pytest.mark.parametrize("inds,K,ok", [(64, 256, True), (64, 512, True),
                                       (64, 1025, True), (64, 1280, True),
                                       (64, 1281, False), (128, 1024, True),
                                       (128, 1025, False), (64, 5120, False)])
def test_k1_point_limit(inds, K, ok):
    """K1 takes any K up to max_points(num_inds) (1,280 at 64 inducing
    points, so FST's 1025-point frames and the serving default 256) and
    refuses more before any launch; meta tensors stand in for the card."""
    model = ST(dim_input=2, dim_output=10, num_inds=inds, dim_hidden=64, num_heads=8)
    assert k1.max_points(64) == 1280 and k1.max_points(128) == 1024
    assert k1.max_points(0) == k1.max_points(129) == 0
    pts = torch.empty(4, K, 2, device="meta")
    if ok:
        k1._check_kernel(model, pts)
        assert K <= k1.max_points(inds)
    else:
        with pytest.raises(ValueError, match="limit"):
            k1._check_kernel(model, pts)
        with pytest.raises(ValueError, match="limit"):
            k1.fused_st_forward(model, pts)


@pytest.mark.parametrize("K,F,ok", [(256, 512, True), (512, 512, True),
                                    (1025, 512, True), (5120, 512, True),
                                    (5121, 512, False), (10, 6000, False)])
def test_k2_k_limit(K, F, ok):
    """K2 takes any K up to Nt·F while a chunk fits in its shared memory
    (the TPU kernel's 256 was its scatter budget), and refuses more before
    any launch."""
    mags = torch.empty(3, 10, F, device="meta")
    assert k2.max_k(5120) == 5120 and k2.max_k(k2.MAX_CHUNK + 1) == 0
    if ok:
        k2._check(mags, K)
    else:
        with pytest.raises(ValueError):
            k2._check(mags, K)
        with pytest.raises(ValueError):
            k2.exact_topk_chunks(mags, K)
