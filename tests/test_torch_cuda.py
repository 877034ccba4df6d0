"""Each CUDA kernel of pcaudio_torch == its plain PyTorch version, on the
card, at small shapes (K4 also at the FST and 3ST recipes' attends, at a
small batch); and the kernel path == the plain path end to end.
This file imports no jax, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q

Every test needs an NVIDIA GPU and skips elsewhere.
"""
import numpy as np
import pytest
import torch

from pcaudio_torch.eval import TemporalPipelineConfig, make_temporal_classifier
from pcaudio_torch.nn import ST
from pcaudio_torch.ops.kernels.featurize import (
    fused_chunk_mag2, fused_chunk_mag2_plain)
from pcaudio_torch.ops.kernels.fused_st import (
    fused_st_forward, fused_st_forward_plain)
from pcaudio_torch.ops.kernels.mha import (
    fused_mha, fused_mha_bwd, fused_mha_bwd_plain, fused_mha_fwd,
    fused_mha_plain)
from pcaudio_torch.ops.kernels.select import (
    exact_topk_chunks, exact_topk_chunks_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _full_st(din, device):
    torch.manual_seed(0)
    return ST(dim_input=din, dim_output=10, num_inds=64, dim_hidden=64,
              num_heads=8).to(device).eval()


@pytest.mark.parametrize("din,K,pattern", [(3, 128, "full"), (3, 64, "ragged"),
                                           (2, 100, "all_masked")])
def test_fused_st_kernel_matches_plain(cuda, din, K, pattern):
    """K1 vs the plain ST, both f32 on the card: 1e-3 (the kernel's
    summation order and __expf differ from cuBLAS and torch.exp)."""
    model = _full_st(din, cuda)
    rng = np.random.default_rng(4)
    B = 6
    pts = torch.from_numpy(rng.standard_normal((B, K, din)).astype(np.float32)).to(cuda)
    if pattern == "full":
        mask = None
    else:
        counts = torch.tensor([K, K - 5, 10, 3, 1, K // 2])
        if pattern == "all_masked":
            counts[1] = counts[-1] = 0
        mask = (torch.arange(K)[None, :] < counts[:, None]).to(cuda)
    before = fused_st_forward.launches
    got = fused_st_forward(model, pts, mask)
    torch.cuda.synchronize()
    assert fused_st_forward.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, fused_st_forward_plain(model, pts, mask),
                               atol=1e-3, rtol=0)
    # bf16 points are widened exactly
    got16 = fused_st_forward(model, pts.bfloat16(), mask)
    torch.testing.assert_close(
        got16, fused_st_forward_plain(model, pts.bfloat16(), mask),
        atol=1e-3, rtol=0)


@pytest.mark.parametrize("K,F", [(128, 512), (64, 512), (128, 130), (256, 1025)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["random", "ties", "zeros", "subnormal"])
def test_select_kernel_matches_plain(cuda, K, F, dtype, kind):
    """K2 == the plain version exactly, ties and subnormals included."""
    rng = np.random.default_rng(1)
    m = np.abs(rng.standard_normal((5, 10, F))).astype(np.float32)
    if kind == "ties":
        m = np.floor(m * 5.0).clip(0, 15).astype(np.float32) / 4.0
    elif kind == "zeros":
        m = np.zeros_like(m)
        m[1, 3, 7] = 1.0
    elif kind == "subnormal":
        m = m * np.float32(1e-39)
    x = torch.from_numpy(m).to(device=cuda, dtype=dtype)
    before = exact_topk_chunks.launches
    gv, gi = exact_topk_chunks(x, K)
    torch.cuda.synchronize()
    assert exact_topk_chunks.launches == before + 1
    rv, ri = exact_topk_chunks_plain(x, K)
    assert torch.equal(gi, ri)
    assert torch.equal(gv, rv)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trim", [True, False])
def test_featurize_kernel_matches_plain(cuda, out_dtype, trim):
    """K3 vs the plain version: equal masks; |X|² on valid chunks within
    1e-5·chunk max + rtol 1e-4 (radix-2 FFT vs cuFFT summation order), plus
    one bf16 step (at most 2^-7 relative) when stored in bf16, where a value
    near a rounding boundary can round either way."""
    rng = np.random.default_rng(5)
    B, L = 5, 40960
    waves = (0.2 * rng.standard_normal((B, L))).astype(np.float32)
    waves[1, :8000] = 1e-6 * rng.standard_normal(8000)   # trimmed lead-in
    waves[2, -6000:] = 0.0                               # trimmed tail
    lengths = torch.tensor([L, 30000, L, 700, 1], dtype=torch.int32).to(cuda)
    w = torch.from_numpy(waves).to(cuda)
    before = fused_chunk_mag2.launches
    got, gm = fused_chunk_mag2(w, lengths, trim=trim, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fused_chunk_mag2.launches == before + 1
    ref, rm = fused_chunk_mag2_plain(w, lengths, trim=trim, out_dtype=out_dtype)
    assert torch.equal(gm, rm)
    assert torch.isfinite(got.float()).all()
    rtol = 1e-4 + (2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0)
    g, r = got.float()[rm], ref.float()[rm]
    atol = 1e-5 * r.amax(dim=(1, 2), keepdim=True)
    assert ((g - r).abs() <= atol + rtol * r.abs()).all()


def test_featurize_kernel_edge_lengths(cuda):
    """Trim bounds at edge lengths (0, 1, around 512 and 1024 multiples,
    the full buffer) and quiet or silent stretches: the kernel's chunk masks
    and valid |X|² equal the plain version's."""
    rng = np.random.default_rng(6)
    B, L = 64, 24576
    lens = rng.integers(0, L + 1, B)
    lens[:10] = [0, 1, 511, 512, 513, 1023, 1024, 2560, L - 1, L]
    waves = np.zeros((B, L), np.float32)
    for i, n in enumerate(lens):
        x = rng.standard_normal(n) * 10 ** rng.uniform(-3, 0)
        if i % 4 == 1:
            x[: n // 3] *= 1e-5
        elif i % 4 == 2:
            x[n - n // 3:] *= 1e-5
        elif i % 4 == 3:
            x[:] = 0.0
        waves[i, :n] = x
    w = torch.from_numpy(waves).to(cuda)
    ln = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    got, gm = fused_chunk_mag2(w, ln, out_dtype=torch.float32)
    ref, rm = fused_chunk_mag2_plain(w, ln, out_dtype=torch.float32)
    assert torch.equal(gm, rm)
    assert torch.isfinite(got).all()
    g, r = got[rm], ref[rm]
    atol = 1e-5 * r.amax(dim=(1, 2), keepdim=True)
    assert ((g - r).abs() <= atol + 1e-4 * r.abs()).all()


def test_kernel_path_matches_plain_path(cuda):
    """Full-width 3ST, bf16 serving config, the three kernels vs their plain
    versions end to end.  Argmax must agree except where the plain path's
    top-2 gap is below twice the largest logit deviation; logits within
    5e-2 (on bf16 grids a value at a rounding boundary can move a near-tie
    winner)."""
    model = _full_st(3, cuda)
    cfg = TemporalPipelineConfig(top_k=128, stft_precision="default",
                                 compute_dtype="bfloat16")
    rng = np.random.default_rng(3)
    B, L = 4, 65536
    t = np.arange(L) / 44100.0
    f0 = rng.uniform(200.0, 3000.0, (B, 1))
    waves = (0.3 * np.sin(2 * np.pi * f0 * t)
             + 0.05 * rng.standard_normal((B, L))).astype(np.float32)
    w = torch.from_numpy(waves).to(cuda)
    ln = torch.tensor([60000, 42000, L, 900], dtype=torch.int32).to(cuda)
    fns = (fused_chunk_mag2, exact_topk_chunks, fused_st_forward)
    counts = [f.launches for f in fns]
    got = make_temporal_classifier(model, cfg, use_fused_st=True)(w, ln)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [c + 1 for c in counts]
    ref = make_temporal_classifier(model, cfg, use_fused_st=True,
                                   plain=True)(w, ln)
    dev = (got - ref).abs().max().item()
    assert torch.isfinite(got).all() and dev <= 5e-2
    top2 = ref.sort(dim=-1).values[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) >= 2 * dev
    assert torch.equal(got.argmax(-1)[decided], ref.argmax(-1)[decided])


def _close_k4(got, ref, what):
    """K4's tolerance, f32 on both sides: 1e-4 of the largest |ref| plus
    1e-4 relative (online softmax, __expf and a different summation order)."""
    err = (got - ref).abs()
    bound = 1e-4 * ref.abs().max() + 1e-4 * ref.abs()
    assert bool((err <= bound).all()), (
        f"{what}: max |err| {err.max().item():.3e}, max |ref| "
        f"{ref.abs().max().item():.3e}")


@pytest.mark.parametrize("B,N,M,pattern,h", [
    (6, 64, 1025, "full", 8),     # FST MAB0: inducing points over the frame
    (6, 1025, 64, "full", 8),     # FST MAB1: the frame over the summaries
    (6, 1, 1025, "full", 8),      # FST PMA: one seed
    (2, 64, 5120, "full", 8),     # 3ST MAB0
    (2, 5120, 64, "full", 8),     # 3ST MAB1
    (2, 1, 5120, "full", 8),      # 3ST PMA
    (5, 64, 300, "ragged", 8),    # ragged keys, one sample all masked
    (5, 1, 37, "ragged", 8),
    (5, 300, 9, "ragged", 8),
    (5, 70, 300, "ragged", 16),   # head width 4
    (5, 70, 300, "ragged", 4),    # head width 16
], ids=lambda x: str(x))
def test_mha_kernels_match_plain(cuda, B, N, M, pattern, h):
    """K4 forward and backward vs the plain pair: out, and dq, dk, dv both
    from the autograd.Function and from autograd through the plain
    forward."""
    dv = 64
    scale = 1.0 / dv ** 0.5
    rng = np.random.default_rng(7)

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(cuda)

    q, k, v, g = t(B, N, dv), t(B, M, dv), t(B, M, dv), t(B, N, dv)
    mask = None
    if pattern == "ragged":
        counts = torch.tensor([M, M - 3, M // 2, 1, 0])[:B]
        mask = (torch.arange(M)[None, :] < counts[:, None]).to(cuda)
    f0, b0 = fused_mha_fwd.launches, fused_mha_bwd.launches
    out, lse = fused_mha_fwd(q, k, v, mask, h, scale)
    dq, dk, dvv = fused_mha_bwd(q, k, v, mask, out, lse, g, h, scale)
    torch.cuda.synchronize()
    assert (fused_mha_fwd.launches, fused_mha_bwd.launches) == (f0 + 1, b0 + 1)
    _close_k4(out, fused_mha_plain(q, k, v, mask, h, scale), "out")
    ref = fused_mha_bwd_plain(q, k, v, mask, g, h, scale)
    for got, r, name in zip((dq, dk, dvv), ref, ("dq", "dk", "dv")):
        _close_k4(got, r, name)
    if pattern == "ragged":   # the all-masked sample: zeros, not NaN
        assert not out[4].any() and not dq[4].any() and not dk[4].any()

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (fused_mha(*leaves, mask, h, scale) * g).sum().backward()
    auto = [x.clone().requires_grad_() for x in (q, k, v)]
    (fused_mha_plain(*auto, mask, h, scale) * g).sum().backward()
    for a, r, name in zip(leaves, auto, ("dq", "dk", "dv")):
        _close_k4(a.grad, r.grad, f"autograd {name}")


def test_mha_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(2, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="head width"):
        fused_mha(q, q, q, None, 2, 0.125)           # dh 32
    with pytest.raises(TypeError, match="float32"):
        fused_mha(q.double(), q.double(), q.double(), None, 8, 0.125)


# ---- the probe kernels (csrc/probe_mma.cu, csrc/probe_attend.cu) -----------

from pcaudio_torch.ops.kernels.probes import (  # noqa: E402
    attend_bound, exp_chain_bound, matmul_bound, probe_attend, probe_attend_plain,
    probe_chain, probe_chain_plain, probe_exp_chain, probe_exp_chain_plain,
    probe_matmul, probe_matmul_plain, signed_permutation)


def _within(got, ref, bound, what):
    """|got − ref| ≤ bound elementwise; equal values (infinities included)
    count as equal."""
    err = torch.where(got == ref, torch.zeros_like(ref), (got - ref).abs())
    bound = torch.as_tensor(bound, dtype=torch.float32, device=ref.device)
    assert bool((err <= bound).all()), (
        f"{what}: max |err| {err.max().item():.3e}, bound there "
        f"{bound.expand_as(err).flatten()[int(torch.argmax(err - bound))].item():.3e}")


@pytest.mark.parametrize("a_shape,b_shape,reps,shift,repeats", [
    ((8, 512, 64), (8, 64, 128), 1, 0, 1),        # P1: the batched dot
    ((128, 128), (128, 128), 1, 0, 1),            # P2: the small product
    ((256 + 8 * 3, 512), (512, 256), 4, 8, 3),    # P2: windows, odd repeats
    ((1024 + 8 * 63, 128), (128, 128), 64, 8, 16),  # P2: the attend shape
], ids=str)
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_probe_matmul_matches_plain(cuda, a_shape, b_shape, reps, shift, repeats,
                                    dtype):
    """Integer operands in [-4, 4): int8 → int32 and bf16 → f32 are both
    exact; N(0, 1) bf16 operands within matmul_bound (f32 sums)."""
    gen = torch.Generator(cuda).manual_seed(0)
    a = torch.randint(-4, 4, a_shape, generator=gen, device=cuda).to(dtype)
    b = torch.randint(-4, 4, b_shape, generator=gen, device=cuda).to(dtype)
    n0 = probe_matmul.launches
    got = probe_matmul(a, b, reps, shift, repeats)
    torch.cuda.synchronize()
    assert probe_matmul.launches == n0 + 1
    ref = probe_matmul_plain(a, b, reps, shift, repeats)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    if dtype == torch.bfloat16:
        a = torch.randn(a_shape, generator=gen, device=cuda).bfloat16()
        b = torch.randn(b_shape, generator=gen, device=cuda).bfloat16()
        _within(probe_matmul(a, b, reps, shift, repeats),
                probe_matmul_plain(a, b, reps, shift, repeats),
                matmul_bound(a, b, reps, shift, repeats), "bf16 N(0, 1)")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n,repeats", [(256, 16), (1024, 256)])
def test_probe_chain_matches_plain(cuda, d, n, repeats):
    """P4a at a signed permutation w (every product exact, x keeps its
    values through all 64 products, and a wrong step count gives another
    result): equal, up to the probe's own shape.  The script's w decays x
    to 0, where equality would show nothing."""
    gen = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(n, d, generator=gen, device=cuda).bfloat16()
    w = signed_permutation(d, gen, cuda)
    n0 = probe_chain.launches
    got = probe_chain(x, w, 64, repeats)
    torch.cuda.synchronize()
    assert probe_chain.launches == n0 + 1
    ref = probe_chain_plain(x, w, 64, repeats)
    assert bool((ref != 0).all()) and torch.equal(got, ref)


@pytest.mark.parametrize("reps", [1, 2])
def test_probe_exp_chain_matches_plain(cuda, reps):
    """N(0, 1) inputs stay finite for two steps (the third overflows)."""
    gen = torch.Generator(cuda).manual_seed(2)
    x = torch.randn(1024, 96, generator=gen, device=cuda)
    got = probe_exp_chain(x, reps, 8)
    ref = probe_exp_chain_plain(x, reps, 8)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ref).all())
    _within(got, ref, exp_chain_bound(ref), "exp chain")


@pytest.mark.parametrize("case,wrong", [
    ("chain d=64", "one step short"), ("chain d=128", "writes zeros"),
    ("exp d=64", "one step short"), ("exp d=128", "writes +inf")])
def test_lane_width_check_catches_a_wrong_kernel(cuda, case, wrong):
    """The lane-width probe's own check (chip_smoke phase 8), given a kernel
    that is wrong in one of the ways the script's decaying or overflowing
    values would hide, raises; given the kernel, it passes."""
    from pcaudio_torch.probes import lane_width
    from pcaudio_torch.probes.timing import measure, tf32_off
    gen = torch.Generator(cuda).manual_seed(0)
    with tf32_off():
        c = {c.name: c for c in lane_width.cases(cuda, gen)}[case]
        c.iters = c.plain_iters = 1
        measure(c)  # raises outside the bound
        args, plain = c.check[0].__defaults__, c.check[1]
        wrong_kernel = {
            "one step short": lambda: (
                probe_chain(*args, lane_width.REPS - 1, lane_width.GRID)
                if case.startswith("chain") else
                probe_exp_chain(*args, lane_width.CHECK_EXP_REPS - 1, lane_width.GRID)),
            "writes zeros": lambda: torch.zeros_like(plain()),
            "writes +inf": lambda: torch.full_like(plain(), float("inf")),
        }[wrong]
        c.check = (wrong_kernel, plain)
        with pytest.raises(AssertionError, match="outside its bound"):
            measure(c)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_probe_attend_matches_plain(cuda, mode):
    """P3 at the script's shapes, 32 grid steps instead of 1024, within
    attend_bound (f32 sums; a bf16 or a8 rounding that a last-ulp
    difference can flip)."""
    gen = torch.Generator(cuda).manual_seed(3)
    iq = 1.5 * torch.randn(1024, 128, generator=gen, device=cuda)
    kmat = 1.2 * torch.randn(2 * 8 * 128, 128, generator=gen, device=cuda)
    n0 = probe_attend.launches
    got = probe_attend(iq, kmat, mode, 8, 128, 32)
    torch.cuda.synchronize()
    assert probe_attend.launches == n0 + 1
    _within(got, probe_attend_plain(iq, kmat, mode, 8, 128, 32),
            attend_bound(iq, kmat, mode, 8, 128, 32), mode)


def test_probe_kernels_reject_what_they_do_not_take(cuda):
    a = torch.zeros(100, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiples"):
        probe_matmul(a, torch.zeros(64, 128, dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError, match="d 64 or 128"):
        probe_chain(torch.zeros(64, 32, dtype=torch.bfloat16, device=cuda),
                    torch.zeros(32, 32, dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError, match="keys"):
        probe_attend(torch.zeros(128, 64, device=cuda), torch.zeros(2048, 64, device=cuda),
                     "bf16")
