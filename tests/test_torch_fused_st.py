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
                                           (2, 256, "all_masked"), (2, 1025, "ragged"),
                                           (3, 5120, "ragged")])
def test_plain_matches_f32_st(din, K, pattern):
    """Full width, up to FST's 1025-point frames and the scratch form's
    5,120-point temporal grids: the bf16 roundings keep the logits within
    the JAX tests' bar of the f32 model."""
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


def _empty_cloud_logits(tm):
    """The logits of a cloud with no valid point, from the weights: every
    MAB0 and the PMA attend to nothing, so the PMA's output is its
    projected seed query sq, and the logits Linear(sq + relu(bf16(sq) Wo +
    bo)), bf16 products with f32 sums."""
    pma = tm.dec[0]
    with torch.no_grad():
        sq = pma.mab.fc_q(pma.S[0])
        p = sq + torch.relu(k1._lin(sq, pma.mab.fc_o))
        return k1._lin(p, tm.dec[1])[0]


@pytest.mark.parametrize("din,K,width", [(3, 128, "full_3st"), (2, 1025, "full_3st"),
                                         (3, 40, "small")])
def test_plain_per_cloud_mask(din, K, width):
    """A mask broadcast along K (one flag a cloud, as the serving pipeline
    builds it): the valid clouds' logits are the mask-free ones bit for
    bit; every invalid cloud gets the one logit row of an empty cloud,
    whatever its points, the row a dense all-false mask gives and the one
    the weights alone give."""
    _, dim, inds, heads = WIDTHS[width]
    _, tm = _pair(din, dim, inds, heads, seed=K)
    rng = np.random.default_rng(K)
    N = 9
    pts = torch.from_numpy(rng.standard_normal((N, K, din)).astype(np.float32))
    valid = torch.from_numpy(rng.random(N) < 0.5)
    valid[:2] = torch.tensor([True, False])
    mask = valid[:, None].expand(N, K)
    assert mask.stride(1) == 0
    got = k1.fused_st_forward_plain(tm, pts, mask)
    assert torch.equal(got[valid], k1.fused_st_forward_plain(tm, pts, None)[valid])
    empty = got[~valid]
    assert torch.equal(empty, empty[:1].expand_as(empty))
    moved = pts.clone()
    moved[~valid] = torch.from_numpy(
        rng.standard_normal((int((~valid).sum()), K, din)).astype(np.float32)) * 10
    assert torch.equal(k1.fused_st_forward_plain(tm, moved, mask)[~valid], empty)
    dense = mask.contiguous()
    assert dense.stride(1) == 1 and not dense[~valid].any()
    assert torch.equal(k1.fused_st_forward_plain(tm, pts, dense), got)
    torch.testing.assert_close(empty[0], _empty_cloud_logits(tm), atol=1e-6, rtol=1e-6)


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
        assert torch.equal(take_f(10), k1._empty_logits(sq, pma.fc_o, dense))
    assert ib == wb.numel() and iff == wf.numel()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_empty_logits_round_as_fma(seed):
    """The packed logits of an empty cloud are the kernel's chain of fmaf
    steps: each step emulated as one exact float64 sum of an exact product
    rounded once to f32 gives the same bits; and they are the plain
    version's empty-cloud logits up to the summation order."""
    _, tm = _pair(3, 64, 64, 8, seed=seed)
    pma, dense = tm.dec[0].mab, tm.dec[1]
    bf = lambda t: t.detach().float().to(torch.bfloat16).double()

    def fma_chain(x, layer):
        a, w = bf(x), bf(layer.weight.T)
        r = layer.bias.detach().float()
        for k in range(a.numel()):
            r = (a[k] * w[k] + r.double()).float()
        return r
    with torch.no_grad():
        sq = pma.fc_q(tm.dec[0].S[0]).reshape(-1)
        v = sq + 0.0
        v = v + fma_chain(v, pma.fc_o).clamp_min(0.0)
        want = fma_chain(v, dense)
        got = k1._empty_logits(sq, pma.fc_o, dense)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, _empty_cloud_logits(tm), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("inds,K,ok", [(64, 256, True), (64, 512, True),
                                       (64, 1025, True), (64, 1280, True),
                                       (64, 1281, False), (128, 1024, True),
                                       (128, 1025, False), (64, 5120, False)])
def test_k1_point_limit(inds, K, ok):
    """K1's shared-memory form takes any K up to max_points(num_inds)
    (1,280 at 64 inducing points, so FST's 1025-point frames and the
    serving default 256; ``ok``); above it the scratch form takes the
    cloud (the full 5,120-point temporal grids), up to
    MAX_SCRATCH_POINTS, and one point more is refused before any launch;
    meta tensors stand in for the card."""
    model = ST(dim_input=2, dim_output=10, num_inds=inds, dim_hidden=64, num_heads=8)
    assert k1.max_points(64) == 1280 and k1.max_points(128) == 1024
    assert k1.max_points(0) == k1.max_points(129) == 0
    assert k1.max_scratch_points(inds) == k1.MAX_SCRATCH_POINTS
    assert k1.max_scratch_points(0) == k1.max_scratch_points(129) == 0
    pts = torch.empty(4, K, 2, device="meta")
    form = k1._check_kernel(model, pts)
    assert form == ("shared" if ok else "scratch")
    assert (K <= k1.max_points(inds)) == ok
    over = torch.empty(4, k1.MAX_SCRATCH_POINTS + 1, 2, device="meta")
    with pytest.raises(ValueError, match="limit"):
        k1._check_kernel(model, over)
    with pytest.raises(ValueError, match="limit"):
        k1.fused_st_forward(model, over)


@pytest.mark.parametrize("inds,K,slab", [(64, 5120, 5120 * 128), (64, 5121, 5184 * 128),
                                         (128, 1025, 1152 * 128)])
def test_k1_scratch_slab(inds, K, slab):
    """A slab holds one cloud's ISAB 1 output, K rounded up to the
    kernel's tile (64 rows with 4 warps, 128 with 8), 64 bf16 a row; the
    scratch's grid is capped by SCRATCH_BYTES (about 400 slabs at 5,120
    points, beside 3 blocks on each of the H100's 132 SMs)."""
    assert k1.slab_bytes(K, inds) == slab
    assert k1.SCRATCH_BYTES // k1.slab_bytes(5120, 64) == 409


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


def test_k1_stage_variants_apply():
    """K1's stage probe builds its variants by editing the shared-memory
    form's sources (``fused_st.cu`` and its header ``fused_st.cuh``): each
    edit finds its text in exactly one place, and text found nowhere
    raises."""
    from pcaudio_torch.probes import k1_stages

    src = k1_stages.k1_sources()
    assert set(src) == {"fused_st.cu", "fused_st.cuh", "mma.cuh"}
    assert '#include "fused_st.cuh"' in src["fused_st.cu"]
    for old, new in k1_stages.VARIANTS.values():
        got = k1_stages.variant_sources(src, old, new)
        changed = [n for n in src if got[n] != src[n]]
        assert len(changed) == 1 and new in got[changed[0]]
    with pytest.raises(ValueError):
        k1_stages.variant_sources(src, "no such text", "x")


def test_k1_stage_probe_reads_one_kernels_sass(monkeypatch):
    """The before/after comparison reads the instructions of the one kernel
    it names from ``cuobjdump -sass``, without addresses or encodings, and
    none of another kernel's."""
    import subprocess

    from pcaudio_torch.probes import k1_stages

    text = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_115fused_st_kernelILi3ELi8EEEvPKv",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */",
        "\t\tFunction : _ZN12_GLOBAL__N_115fused_st_kernelILi3ELi4EEEvPKv",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */",
        "                                                            /* 0x000fe40000000800 */",
        "        /*0010*/                   BRA 0x10 ;               /* 0xfffffffc00fc7947 */",
        "\t\tFunction : _ZN12_GLOBAL__N_16mha_fwd_kernelILi8ELi1EEEvPKf",
        "        /*0000*/                   EXIT ;                   /* 0x000000000000794d */",
    ])
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(
        a, 0, stdout=text, stderr=""))
    assert k1_stages._kernel_sass("lib.so") == ["LDC R1, c[0x0][0x28]", "BRA 0x10"]
