"""Each CUDA kernel of pcaudio_torch == its plain PyTorch version, on the
card, at small shapes (K4 also at the FST and 3ST recipes' attends, at a
small batch); and the kernel path == the plain path end to end.
This file imports no jax, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q

Every test needs an NVIDIA GPU and skips elsewhere.
"""
import json
import os

import numpy as np
import pytest
import torch

from pcaudio_torch.dsp import stft_window, trim_bounds
from pcaudio_torch.eval import TemporalPipelineConfig, make_temporal_classifier
from pcaudio_torch.serve import AudioClassifier
from pcaudio_torch.nn import ST
from pcaudio_torch.ops.kernels.featurize import (
    fused_chunk_mag2, fused_chunk_mag2_plain)
from pcaudio_torch.ops.kernels import _build
from pcaudio_torch.ops.kernels.fused_st import (
    MAX_SCRATCH_POINTS, _packed_weights, fused_st_forward, fused_st_forward_plain,
    launch_packed, launch_scratch, max_points, resident_blocks, slab_bytes)
from pcaudio_torch.ops.subsample import topk_stable
from pcaudio_torch.ops.kernels.mha import (
    fused_mha, fused_mha_bwd, fused_mha_bwd_plain, fused_mha_fwd,
    fused_mha_plain)
from pcaudio_torch.ops.kernels.select import (
    MAX_CHUNK, exact_topk_chunks, exact_topk_chunks_plain)
from pcaudio_torch.ops.kernels.approx_select import (
    approx_topk_chunks, approx_topk_chunks_plain, approx_topk_plan)
from pcaudio_torch.probes.clips import negzero_grid
from pcaudio_torch.probes.timing import SortCalls

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


@pytest.mark.parametrize("din,K,pattern,M", [
    (3, 128, "full", 64), (3, 64, "ragged", 64), (2, 100, "all_masked", 64),
    (3, 256, "full", 64), (2, 1025, "ragged", 64), (2, 1280, "ragged", 64),
    (3, 17, "ragged", 20), (3, 200, "ragged", 128), (2, 1024, "full", 128)])
def test_fused_st_kernel_matches_plain(cuda, din, K, pattern, M):
    """K1 vs its plain version (both round to bf16 at the same places):
    |err| <= 1e-2 + 1e-2·|ref| (a value at a rounding boundary can round
    either way after another summation order or the online softmax's
    rescaling); and vs the f32 ST within the JAX tests' 5e-2.  Up to the
    kernel's point limit, with 4 warps (num_inds <= 64) and 8."""
    torch.manual_seed(0)
    model = ST(dim_input=din, dim_output=10, num_inds=M, dim_hidden=64,
               num_heads=8).to(cuda).eval()
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
    for x in (pts, pts.bfloat16()):
        before = fused_st_forward.launches
        got = fused_st_forward(model, x, mask)
        torch.cuda.synchronize()
        assert fused_st_forward.launches == before + 1
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, fused_st_forward_plain(model, x, mask),
                                   atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(got, model(x.float(), mask), atol=5e-2, rtol=5e-2)


def test_fused_st_limits_match_the_kernel(cuda):
    """The wrapper's point limit is the kernel's own, and the kernel refuses
    one point more."""
    lib = _build.library()
    for m in (1, 16, 64, 65, 128, 129):
        assert lib.pcaudio_fused_st_max_points(m) == max_points(m)
    model = _full_st(2, cuda)
    pts = torch.zeros(1, max_points(64) + 1, 2, device=cuda)
    w = _packed_weights(model, cuda)
    out = torch.empty(1, 10, device=cuda)
    with pytest.raises(RuntimeError, match="pcaudio_fused_st"):
        launch_packed(pts, None, w, out, 64)


def _ragged(K, B, device, seed=5):
    counts = torch.from_numpy(np.random.default_rng(seed).integers(0, K + 1, B))
    counts[:3] = torch.tensor([K, 0, 1])
    return (torch.arange(K)[None, :] < counts[:, None]).to(device)


@pytest.mark.parametrize("K", [1281, 2048, 5120])
@pytest.mark.parametrize("pattern", ["full", "ragged"])
@pytest.mark.parametrize("din", [2, 3])
def test_fused_st_scratch_form_matches_plain(cuda, K, pattern, din):
    """K1's scratch form (ISAB 1's output in device memory) past the
    shared-memory form's 1,280 points: against its plain version at K1's
    bar (1e-2 + 1e-2·|ref|), f32 and bf16 points, no mask and a ragged one
    (a full, an empty and a one-point cloud among them); one launch of the
    scratch form and none of the shared one."""
    model = _full_st(din, cuda)
    B = 9
    pts = torch.from_numpy(np.random.default_rng(K).standard_normal(
        (B, K, din)).astype(np.float32)).to(cuda)
    mask = None if pattern == "full" else _ragged(K, B, cuda)
    for x in (pts, pts.bfloat16()):
        before = (fused_st_forward.launches, launch_scratch.launches)
        got = fused_st_forward(model, x, mask)
        torch.cuda.synchronize()
        assert (fused_st_forward.launches, launch_scratch.launches) == (
            before[0], before[1] + 1)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, fused_st_forward_plain(model, x, mask),
                                   atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("K", [64, 1025, 1280])
@pytest.mark.parametrize("M", [64, 128])
def test_fused_st_scratch_form_equals_shared_form(cuda, K, M):
    """Where both forms take a cloud they compute the same function in the
    same order: bit-identical logits, with and without a mask, on more
    clouds than the scratch form's grid has blocks (each walks several)."""
    if K > max_points(M):
        K = max_points(M)
    torch.manual_seed(1)
    model = ST(dim_input=3, dim_output=10, num_inds=M, dim_hidden=64,
               num_heads=8).to(cuda).eval()
    B = 2 * resident_blocks(torch.cuda.current_device(), 3, M, K) + 3
    pts = torch.randn(B, K, 3, device=cuda)
    w = _packed_weights(model, cuda)
    for mask in (None, _ragged(K, B, cuda)):
        shared = torch.empty(B, 10, device=cuda)
        launch_packed(pts, mask, w, shared, M)
        scratch = torch.full((B, 10), float("nan"), device=cuda)
        launch_scratch(pts, mask, w, scratch, M)
        torch.cuda.synchronize()
        assert torch.equal(scratch, shared), mask is None


def test_fused_st_scratch_form_refuses(cuda):
    """What the scratch form cannot take raises before a launch: more points
    than MAX_SCRATCH_POINTS (the wrapper), a scratch buffer smaller than
    its grid's slabs (the kernel's entry point), a grid of 0 blocks."""
    model = _full_st(3, cuda)
    with pytest.raises(ValueError, match="limit"):
        fused_st_forward(model, torch.zeros(1, MAX_SCRATCH_POINTS + 1, 3, device=cuda))
    lib = _build.library()
    assert lib.pcaudio_fused_st_scratch_max_points(64) == MAX_SCRATCH_POINTS
    assert lib.pcaudio_fused_st_scratch_max_points(129) == 0
    pts = torch.zeros(2, 2048, 3, device=cuda)
    wb, wf = _packed_weights(model, cuda)
    out = torch.empty(2, 10, device=cuda)
    small = torch.empty(slab_bytes(2048, 64) // 2 - 1, dtype=torch.bfloat16, device=cuda)
    for grid, scratch in ((1, small), (0, small)):
        with pytest.raises(RuntimeError, match="pcaudio_fused_st_scratch"):
            _build.launch("pcaudio_fused_st_scratch", pts.data_ptr(), 0, None, None,
                          wb.data_ptr(), wb.numel(), wf.data_ptr(), wf.numel(),
                          out.data_ptr(), 2, 2048, 3, 64, 10, grid,
                          scratch.data_ptr(), scratch.numel(),
                          _build.stream_of(pts))


def _record_k1_masks(monkeypatch):
    """What each K1 launch hands its kernel of the mask: ``(the [N, K]
    flags' address, the [N] flags' address)``, whichever form runs."""
    seen = []
    launch = _build.launch

    def record(name, *args):
        if name in ("pcaudio_fused_st", "pcaudio_fused_st_scratch"):
            seen.append((args[2], args[3]))
        return launch(name, *args)
    monkeypatch.setattr(_build, "launch", record)
    return seen


@pytest.mark.parametrize("K,M", [(128, 64), (1025, 64), (200, 128), (2048, 64), (5120, 64)])
def test_fused_st_empty_clouds(cuda, monkeypatch, K, M):
    """K1 on a mask of one flag a cloud (broadcast along K, as the serving
    pipeline builds it) and on a dense mask with all-false rows, in the
    shared form (K <= max_points) and the scratch form (on more clouds than
    its grid has blocks): the valid clouds' logits are the mask-free ones
    bit for bit; every invalid cloud gets one row, the packed row of an
    empty cloud, bit for bit the logits that the kernel's masked passes
    give the dense all-false rows, and within K1's bar of the plain
    version; one launch each, and the flags reach the kernel as the cloud
    mask's own storage, with no [N, K] copy."""
    torch.manual_seed(2)
    model = ST(dim_input=3, dim_output=10, num_inds=M, dim_hidden=64,
               num_heads=8).to(cuda).eval()
    scratch = K > max_points(M)
    N = 2 * resident_blocks(torch.cuda.current_device(), 3, M, K) + 3 if scratch else 300
    gen = torch.Generator(cuda).manual_seed(K)
    pts = torch.randn(N, K, 3, generator=gen, device=cuda)
    cloud_mask = torch.rand(N, generator=gen, device=cuda) < 0.5
    cloud_mask[:3] = torch.tensor([True, False, True])
    mask = cloud_mask[:, None].expand(N, K)
    seen = _record_k1_masks(monkeypatch)
    counters = lambda: (fused_st_forward.launches, launch_scratch.launches)
    before = counters()
    got = fused_st_forward(model, pts, mask)
    torch.cuda.synchronize()
    assert counters() == (before[0] + (not scratch), before[1] + scratch)
    assert seen == [(None, cloud_mask.data_ptr())]
    assert torch.isfinite(got).all()
    free = fused_st_forward(model, pts, None)
    assert torch.equal(got[cloud_mask], free[cloud_mask])
    dense = mask.contiguous()
    dense_out = fused_st_forward(model, pts, dense)
    assert seen[-1] == (dense.data_ptr(), None)
    empty = got[~cloud_mask]
    assert torch.equal(dense_out[~cloud_mask], empty)
    assert torch.equal(empty, empty[:1].expand_as(empty))
    assert torch.equal(empty[0], _packed_weights(model, cuda)[1][-10:])
    idx = torch.nonzero(~cloud_mask)[:6, 0]
    torch.testing.assert_close(empty[:len(idx)],
                               fused_st_forward_plain(model, pts[idx], mask[idx]),
                               atol=1e-2, rtol=1e-2)


def test_serving_hands_k1_the_chunk_mask(cuda, monkeypatch):
    """The serving pipeline on a ragged batch: one K1 launch, handed the
    chunk mask itself as a flag a cloud (no copy); the valid chunks'
    logits are the mask-free forward's bit for bit, the invalid chunks'
    one row, and the clip logits those of the mask-free forward."""
    from pcaudio_torch.eval import extract_chunk_clouds, make_chunk_logits

    model = _full_st(3, cuda)
    cfg = TemporalPipelineConfig(top_k=128, stft_precision="default",
                                 compute_dtype="bfloat16")
    rng = np.random.default_rng(9)
    B, L = 6, 65536
    w = torch.from_numpy((0.1 * rng.standard_normal((B, L))).astype(np.float32)).to(cuda)
    ln = torch.tensor([L, 50000, 30000, 12000, 3000, 600], dtype=torch.int32).to(cuda)
    seen = _record_k1_masks(monkeypatch)
    before = fused_st_forward.launches
    logits, chunk_mask = make_chunk_logits(model, cfg, use_fused_st=True)(w, ln)
    torch.cuda.synchronize()
    assert fused_st_forward.launches == before + 1
    assert seen == [(None, chunk_mask.data_ptr())]
    assert chunk_mask.any() and not chunk_mask.all()
    cloud, _ = extract_chunk_clouds(w, ln, cfg)
    free = fused_st_forward(model, cloud.points, None).reshape(logits.shape)
    assert torch.equal(logits[chunk_mask], free[chunk_mask])
    empty = logits[~chunk_mask]
    assert torch.equal(empty, empty[:1].expand_as(empty))
    wt = chunk_mask[..., None].float()
    pooled = (free * wt).sum(1) / wt.sum(1).clamp_min(1.0)
    clip = make_temporal_classifier(model, cfg, use_fused_st=True)(w, ln)
    assert torch.equal(clip, pooled)


def test_full_grid_serving_through_the_scratch_form(cuda):
    """``top_k=None`` serving on both featurize paths: K1 runs its scratch
    form on the 5,120-point clouds and agrees with the plain path."""
    model = _full_st(3, cuda)
    rng = np.random.default_rng(6)
    waves = torch.from_numpy((0.1 * rng.standard_normal((3, 65536))).astype(
        np.float32)).to(cuda)
    lengths = torch.tensor([65536, 40000, 30000], device=cuda)
    for fz in ("fused", "xla"):
        cfg = TemporalPipelineConfig(top_k=None, featurize=fz)
        before = launch_scratch.launches
        got = make_temporal_classifier(model, cfg, use_fused_st=True)(waves, lengths)
        torch.cuda.synchronize()
        assert launch_scratch.launches == before + 1
        ref = make_temporal_classifier(model, cfg, use_fused_st=True, plain=True)(
            waves, lengths)
        torch.testing.assert_close(got, ref, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("kind", ["ties", "negzero", "bf16"])
@pytest.mark.parametrize("n", [300, 5120])
def test_topk_stable_on_the_card_matches_the_cpu(cuda, kind, n):
    """The one ranking on the card (where torch.sort may take a radix sort)
    gives the CPU's indices and values: ties to the lower index, -0.0
    tying with 0.0, on many rows."""
    x = torch.from_numpy(np.floor(np.random.default_rng(n).uniform(
        -2, 2, (2000, n)) * 2).astype(np.float32) / 2)
    if kind == "negzero":
        x = torch.where(x.abs() < 1.0, torch.where(x < 0, -0.0, 0.0), x)
    if kind == "bf16":
        x = x.bfloat16()
    for k in (1, 128, n):
        v, i = topk_stable(x.to(cuda), k)
        rv, ri = topk_stable(x, k)
        assert torch.equal(i.cpu(), ri)
        assert torch.equal(v.cpu(), rv)
        assert torch.equal(torch.signbit(v.cpu()), torch.signbit(rv))


def test_serve_default_top_k_through_kernel(cuda, tmp_path):
    """from_reference_checkpoint's default top_k (256 points a cloud)
    serves a full-width 3ST through K1-K3, as its plain path does."""
    ref_cfg = {"architecture": "3ST (Set Transformer Temporal)",
               "window_size": 1024, "hop_factor": 0.5, "trim_dB": 60,
               "sampling_rate": 44100, "classes": 10, "dhidden": 64,
               "nheads": 8, "ninds": 64, "Ntemp": 10, "np_seed": 1}
    (tmp_path / "3ST_config.json").write_text(json.dumps(ref_cfg))
    model = _full_st(3, "cpu")
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()},
               tmp_path / "3ST_net.pth")
    clf = AudioClassifier.from_reference_checkpoint(
        str(tmp_path / "3ST_config.json"), str(tmp_path / "3ST_net.pth"),
        batch_size=4, device="cuda")
    assert clf.pipeline.top_k == 256
    rng = np.random.default_rng(6)
    clips = [(0.2 * rng.standard_normal(n)).astype(np.float32)
             for n in (220500, 100000, 50000)]
    fns = (fused_chunk_mag2, exact_topk_chunks, fused_st_forward)
    counts = [f.launches for f in fns]
    got = torch.from_numpy(clf.logits(clips))
    assert all(f.launches > c for f, c in zip(fns, counts))
    ref = torch.from_numpy(AudioClassifier(model=clf.model, pipeline=clf.pipeline,
                                           batch_size=4, device="cuda",
                                           plain=True).logits(clips))
    dev = (got - ref).abs().max().item()
    assert torch.isfinite(got).all() and dev <= 5e-2
    top2 = ref.sort(dim=-1).values[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) >= 2 * dev
    assert torch.equal(got.argmax(-1)[decided], ref.argmax(-1)[decided])


@pytest.mark.parametrize("K", [512, 5120])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_kernel_large_k(cuda, K, dtype):
    """K2 above the TPU kernel's 256: expt 2's 512 and every bin of a
    10 x 512 chunk, exactly its plain version, ties included."""
    rng = np.random.default_rng(2)
    m = np.floor(np.abs(rng.standard_normal((7, 10, 512))) * 5.0) / 4.0
    x = torch.from_numpy(m.astype(np.float32)).to(device=cuda, dtype=dtype)
    before = exact_topk_chunks.launches
    gv, gi = exact_topk_chunks(x, K)
    torch.cuda.synchronize()
    assert exact_topk_chunks.launches == before + 1
    rv, ri = exact_topk_chunks_plain(x, K)
    assert torch.equal(gi, ri) and torch.equal(gv, rv)


def _select_grid(N, F, kind, device, dtype, seed=1):
    """[N, 10, F] non-negative grids for K2.  "negzero": ``negzero_grid``
    (-0.0 entries); "equal": every chunk one non-zero value; "mixed":
    all-zero, all-equal and noise chunks in turn."""
    if kind == "negzero":
        return torch.from_numpy(negzero_grid(N, F, seed)).to(device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    m = np.abs(rng.standard_normal((N, 10, F))).astype(np.float32)
    if kind == "ties":
        m = np.floor(m * 5.0).clip(0, 15).astype(np.float32) / 4.0
    if kind == "zeros":
        m = np.zeros_like(m)
        m[1 % N, 3, 7] = 1.0
    elif kind == "subnormal":
        m = m * np.float32(1e-39)
    elif kind == "equal":
        m = np.repeat(rng.uniform(0.5, 2.0, (N, 1, 1)), 10 * F).reshape(N, 10, F)
    elif kind == "mixed":
        m[0::3] = 0.0
        m[1::3] = 0.75
    return torch.from_numpy(m.astype(np.float32)).to(device=device, dtype=dtype)


@pytest.mark.parametrize("K", [128, 512, MAX_CHUNK])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_kernel_largest_chunk(cuda, K, dtype):
    """K2 at the largest chunk it takes (Nt·F = MAX_CHUNK, one buffer and
    the histograms fill a block's shared memory), exactly its plain
    version."""
    x = _select_grid(3, MAX_CHUNK // 10, "ties", cuda, dtype)
    gv, gi = exact_topk_chunks(x, K)
    torch.cuda.synchronize()
    rv, ri = exact_topk_chunks_plain(x, K)
    assert torch.equal(gi, ri)
    assert torch.equal(gv, rv)


@pytest.mark.parametrize("K,F", [(128, 512), (64, 512), (128, 130), (256, 1025)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["random", "ties", "zeros", "subnormal", "negzero",
                                  "equal"])
def test_select_kernel_matches_plain(cuda, K, F, dtype, kind):
    """K2 == the plain version exactly, ties and subnormals included; -0.0
    ties with 0.0 in flat order; all-equal non-zero chunks take the first
    K."""
    x = _select_grid(5, F, kind, cuda, dtype)
    before = exact_topk_chunks.launches
    gv, gi = exact_topk_chunks(x, K)
    torch.cuda.synchronize()
    assert exact_topk_chunks.launches == before + 1
    rv, ri = exact_topk_chunks_plain(x, K)
    assert torch.equal(gi, ri)
    assert torch.equal(gv, rv)


@pytest.mark.parametrize("N", [1, 133])
@pytest.mark.parametrize("K", ["1", "all"])
@pytest.mark.parametrize("F", [512, 130, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["ties", "negzero"])
def test_select_kernel_n_and_k_edges(cuda, N, K, F, dtype, kind):
    """K2 == the plain version at K 1 and K = Nt·F, for one chunk (fewer
    than the SMs) and 133 (not a multiple of the persistent grid), with
    16-byte-aligned chunks (F 512 and 64) and unaligned ones (F 130)."""
    x = _select_grid(N, F, kind, cuda, dtype, seed=N)
    k = 1 if K == "1" else 10 * F
    gv, gi = exact_topk_chunks(x, k)
    torch.cuda.synchronize()
    rv, ri = exact_topk_chunks_plain(x, k)
    assert torch.equal(gi, ri)
    assert torch.equal(gv, rv)


@pytest.mark.parametrize("K", [128, 256])
@pytest.mark.parametrize("F", [512, 130, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_kernel_walks_many_chunks(cuda, K, F, dtype):
    """K2 == the plain version on 5,000 chunks, several a persistent block,
    where all-zero and all-equal chunks (no radix pass) alternate with noise
    chunks, so a block's next chunk arrives while its warps leave the last
    one by different paths."""
    x = _select_grid(5000, F, "mixed", cuda, dtype, seed=F)
    gv, gi = exact_topk_chunks(x, K)
    torch.cuda.synchronize()
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


def _k3_within(got, gm, ref, rm, out_dtype):
    """K3's bar, as in the two tests above: equal masks, finite values, and
    |X|² on valid chunks within 1e-5·chunk max + rtol 1e-4, plus one bf16
    step when stored in bf16."""
    if not torch.equal(gm, rm) or not bool(torch.isfinite(got.float()).all()):
        return False
    rtol = 1e-4 + (2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0)
    g, r = got.float()[rm], ref.float()[rm]
    atol = 1e-5 * r.amax(dim=(1, 2), keepdim=True)
    return bool(((g - r).abs() <= atol + rtol * r.abs()).all())


def _k3_pair(w, ln, out_dtype):
    """The kernel's grid (one launch) and the plain version's."""
    before = fused_chunk_mag2.launches
    got, gm = fused_chunk_mag2(w, ln, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fused_chunk_mag2.launches == before + 1
    ref, rm = fused_chunk_mag2_plain(w, ln, out_dtype=out_dtype)
    return got, gm, ref, rm


def _lead_in_waves(s0, tails, t_last, L=40960, seed=7):
    """One clip per tail in ``tails``: silence, then noise from (s0 + 1)·512
    + 1 (out of reach of trim frame s0 - 1 and of frame 0's reflection) to
    the clip's length s0·512 + t_last·512 + tail, so that the 60 dB trim
    starts at s0·512 and keeps tlen = t_last·512 + tail.  Past each length
    the buffer holds loud noise that no frame may read."""
    rng = np.random.default_rng(seed)
    waves = (5.0 * rng.standard_normal((len(tails), L))).astype(np.float32)
    lengths = np.array([(s0 + t_last) * 512 + r for r in tails], np.int32)
    on = (s0 + 1) * 512 + 1
    for i, n in enumerate(lengths):
        waves[i, :on] = 0.0
        waves[i, on:n] = 0.3 * rng.standard_normal(n - on)
    return waves, lengths


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s0,t_last", [(1, 69), (2, 69), (37, 39)])
def test_featurize_kernel_trim_starts(cuda, s0, t_last, out_dtype):
    """Trim starts of 1, 2 and 37 hops with tlen mod 512 in {0, 1, 511} and
    frame t_last, whose window is reflected, the last frame of a valid
    chunk (t_last = 9 mod 10)."""
    waves, lengths = _lead_in_waves(s0, (0, 1, 511), t_last)
    w = torch.from_numpy(waves).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    start, tlen = trim_bounds(w, ln, top_db=60.0)
    assert (start == s0 * 512).all()
    assert tlen.tolist() == [t_last * 512 + r for r in (0, 1, 511)]
    got, gm, ref, rm = _k3_pair(w, ln, out_dtype)
    assert rm[:, t_last // 10].all() and not rm[:, t_last // 10 + 1:].any()
    assert _k3_within(got, gm, ref, rm, out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L", [(1, 24576), (300, 24576), (7, 24573)])
def test_featurize_kernel_grid_sizes(cuda, B, L, out_dtype):
    """One clip, 300 clips (900 blocks: more than one wave of the grid), and
    rows of an odd length (not 16-byte aligned: the kernel stages them with
    4-byte loads), with ragged lengths, quiet lead-ins of random hops and
    loud samples past each length."""
    rng = np.random.default_rng(8 + B)
    waves = (5.0 * rng.standard_normal((B, L))).astype(np.float32)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[0] = L - 300
    for i, n in enumerate(lengths):
        waves[i, :n] = 0.2 * rng.standard_normal(n)
        lead = int(rng.integers(0, 8)) * 512 + int(rng.integers(0, 512))
        waves[i, :min(lead, n)] *= 1e-5
    got, gm, ref, rm = _k3_pair(torch.from_numpy(waves).to(cuda),
                                torch.from_numpy(lengths).to(cuda), out_dtype)
    assert rm.any()
    assert _k3_within(got, gm, ref, rm, out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_featurize_kernel_silent_and_empty(cuda, out_dtype):
    """A silent clip (kept whole by the trim: every frame 0), length 0 (no
    frame, |X|² 0), length 1 and a short silent clip: every frame of the
    silent and empty clips is exactly 0, as in the plain version, and the
    rest agree."""
    rng = np.random.default_rng(9)
    L = 16384
    waves = (5.0 * rng.standard_normal((5, L))).astype(np.float32)
    lengths = np.array([L, 0, 1, 5000, 12000], np.int32)
    waves[0] = 0.0
    waves[3, :5000] = 0.0
    waves[4, :12000] = 0.2 * rng.standard_normal(12000)
    got, gm, ref, rm = _k3_pair(torch.from_numpy(waves).to(cuda),
                                torch.from_numpy(lengths).to(cuda), out_dtype)
    for b in (0, 1, 3):
        assert not got[b].any() and not ref[b].any()
    assert rm[0].all() and not rm[1].any() and not rm[2].any()
    assert _k3_within(got, gm, ref, rm, out_dtype)


@pytest.mark.parametrize("wrong", ["t_last_unreflected", "run_shifted"])
def test_featurize_check_catches_a_wrong_kernel(cuda, wrong):
    """The K3 comparison rejects the plain grid with frame t_last taken from
    the raw window instead of its reflection, and with the frames of one
    16-frame run shifted by one."""
    s0, t_last = 2, 69
    waves, lengths = _lead_in_waves(s0, (0,), t_last)
    w = torch.from_numpy(waves).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    ref, rm = fused_chunk_mag2_plain(w, ln, out_dtype=torch.float32)
    assert _k3_within(ref, rm, ref, rm, torch.float32)
    bad = ref.clone()
    frames = bad.view(1, -1, 512)
    if wrong == "t_last_unreflected":
        y0 = s0 * 512 + (t_last - 1) * 512
        X = torch.fft.rfft(w[0, y0:y0 + 1024] * stft_window(1024, cuda))
        frames[0, t_last] = (X.real ** 2 + X.imag ** 2)[:512]
    else:
        frames[0, 16:32] = ref.view(1, -1, 512)[0, 15:31]
    assert not torch.equal(bad, ref)
    assert not _k3_within(bad, rm, ref, rm, torch.float32)


def _approx_keys(kind, R, N, device, dtype, seed=1):
    """[R, N] signed keys for K2a: "noise" signed normal, "negative" below
    0 (log-magnitudes), "ties" 16 signed levels, "negzero" ``negzero_grid``
    (-0.0 entries), "equal" one value a row, "mixed" equal, zero and noise
    rows in turn."""
    rng = np.random.default_rng(seed)
    if kind == "negzero":
        m = negzero_grid(R, -(-N // 10), seed).reshape(R, -1)[:, :N]
    else:
        m = rng.standard_normal((R, N))
    if kind == "negative":
        m = -1.0 - np.abs(m)
    elif kind == "ties":
        m = np.floor(m * 4.0).clip(-8, 7) / 4.0
    elif kind == "equal":
        m = np.repeat(rng.uniform(-2.0, 2.0, (R, 1)), N, 1)
    elif kind == "mixed":
        m[0::3] = -0.75
        m[1::3] = 0.0
    return torch.from_numpy(np.ascontiguousarray(m, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _approx_equal(x, K, recall):
    """K2a on ``x`` == its plain version: the same indices, and the same
    values bit for bit (the sign of a selected -0.0 included)."""
    before = approx_topk_chunks.launches
    gv, gi = approx_topk_chunks(x, K, recall)
    torch.cuda.synchronize()
    assert approx_topk_chunks.launches == before + 1
    rv, ri = approx_topk_chunks_plain(x, K, recall)
    assert torch.equal(gi, ri)
    assert torch.equal(gv.view(torch.int32), rv.view(torch.int32))
    return gi


@pytest.mark.parametrize("recall", [0.8, 0.9, 0.95, 0.99])
@pytest.mark.parametrize("K", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["noise", "negative", "ties", "negzero"])
def test_approx_select_kernel_matches_plain(cuda, kind, dtype, K, recall):
    """K2a == its plain version exactly at the serving row (10 x 512 keys)
    for every plan the recall targets give (r 3, 2, 1 and 0 at K 128):
    signed and negative keys, ties inside and across windows, -0.0 tied
    with 0.0."""
    _approx_equal(_approx_keys(kind, 37, 5120, cuda, dtype), K, recall)


@pytest.mark.parametrize("N", [5130, 1000, 130, 133])
@pytest.mark.parametrize("K", [1, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["noise", "ties", "negzero", "equal"])
def test_approx_select_kernel_ragged_rows(cuda, kind, dtype, K, N):
    """K2a == its plain version on rows that are not multiples of 128 · 2^r
    (the last slab padded) and whose bytes are not 16-byte multiples (one
    key a load), at K 1 (XLA's own plan) and where K exceeds the row."""
    if K > N:
        with pytest.raises(ValueError):
            approx_topk_chunks(_approx_keys(kind, 3, N, cuda, dtype), K, 0.9)
        return
    _approx_equal(_approx_keys(kind, 9, N, cuda, dtype), K, 0.9)


@pytest.mark.parametrize("N,K,recall", [(5120, 1, 0.9), (5120, 512, 0.9),
                                        (20480, 128, 0.9), (20480, 256, 0.99),
                                        (5120, 5120, 1.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_approx_select_kernel_plans(cuda, N, K, recall, dtype):
    """K2a == its plain version at the plans' edges: K 1 (64 slabs of 128
    windows), K 512 (no candidate list), long rows (dynamic shared memory
    past 48 KB at r 0), every key at recall 1.0."""
    M, r = approx_topk_plan(N, K, recall)
    assert M >= K
    _approx_equal(_approx_keys("ties", 5, N, cuda, dtype), K, recall)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_approx_select_kernel_many_rows(cuda, dtype):
    """K2a on 5,000 rows of equal, zero and noise rows in turn, and on an
    unaligned view's copy."""
    x = _approx_keys("mixed", 5000, 5120, cuda, dtype)
    _approx_equal(x, 128, 0.9)
    _approx_equal(x[:, 1:].contiguous(), 128, 0.9)
    with pytest.raises(ValueError, match="contiguous"):
        approx_topk_chunks(x[:, 1:], 128, 0.9)


@pytest.mark.parametrize("featurize", ["fused", "xla"])
def test_approx_path_matches_plain_path(cuda, featurize):
    """``extraction="approx"`` end to end at full width, bf16 serving, on
    both featurize paths: K2a selects (no K2, and no sort or top-K on a
    CUDA tensor), K1 classifies, K3 featurizes on the fused path; the
    logits match the plain path's as in test_kernel_path_matches_plain_path
    (within 5e-2, argmax where the plain path's top-2 gap exceeds twice the
    largest deviation)."""
    model = _full_st(3, cuda)
    cfg = TemporalPipelineConfig(top_k=128, stft_precision="default",
                                 compute_dtype="bfloat16", extraction="approx",
                                 featurize=featurize)
    rng = np.random.default_rng(3)
    B, L = 4, 65536
    t = np.arange(L) / 44100.0
    f0 = rng.uniform(200.0, 3000.0, (B, 1))
    waves = (0.3 * np.sin(2 * np.pi * f0 * t)
             + 0.05 * rng.standard_normal((B, L))).astype(np.float32)
    w = torch.from_numpy(waves).to(cuda)
    ln = torch.tensor([60000, 42000, L, 900], dtype=torch.int32).to(cuda)
    fns = (fused_chunk_mag2, exact_topk_chunks, approx_topk_chunks, fused_st_forward)
    counts = [f.launches for f in fns]
    with SortCalls() as sorts:
        got = make_temporal_classifier(model, cfg, use_fused_st=True)(w, ln)
        torch.cuda.synchronize()
    assert sorts.calls == {}
    assert [f.launches - c for f, c in zip(fns, counts)] == [
        int(featurize == "fused"), 0, 1, 1]
    ref = make_temporal_classifier(model, cfg, use_fused_st=True,
                                   plain=True)(w, ln)
    dev = (got - ref).abs().max().item()
    assert torch.isfinite(got).all() and dev <= 5e-2
    top2 = ref.sort(dim=-1).values[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) >= 2 * dev
    assert torch.equal(got.argmax(-1)[decided], ref.argmax(-1)[decided])


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


def _wav_corpus(directory, n, seed=8):
    """n PCM16 WAVs of 0.3-1.5 s of tones and noise, and the clips in memory
    (the Python decoder)."""
    from pcaudio_torch.data.audio_io import load_wav
    from pcaudio_torch.data.synthetic import write_wav_pcm16

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        m = int(rng.integers(13000, 66000))
        t = np.arange(m) / 44100.0
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(200.0, 3000.0) * t) \
            + 0.05 * rng.standard_normal(m)
        paths.append(str(directory / f"c{i:03d}.wav"))
        write_wav_pcm16(paths[-1], x)
    return paths, [load_wav(p)[0] for p in paths]


def _ingest_clf(model, batch, **kw):
    cfg = TemporalPipelineConfig(top_k=128, stft_precision="default",
                                 compute_dtype="bfloat16")
    return AudioClassifier(model=model, pipeline=cfg, batch_size=batch,
                           buffer_len=65536, device="cuda", **kw)


def test_classify_paths_int16_staging_equals_f32_through_kernels(cuda, tmp_path):
    """The native ring on the card: K1-K3 launched, int16 slots give the f32
    slots' logits bit for bit, and both equal logits() on the clips decoded
    in memory (the same waves in the same buckets)."""
    paths, clips = _wav_corpus(tmp_path, 11)
    model = _full_st(3, cuda)
    fns = (fused_chunk_mag2, exact_topk_chunks, fused_st_forward)
    out = {}
    for wd in ("float32", "int16"):
        clf = _ingest_clf(model, 4, wave_dtype=wd)
        counts = [f.launches for f in fns]
        out[wd] = clf.logits_paths(paths)
        assert all(f.launches >= c + 3 for f, c in zip(fns, counts))
        clf.close()
    assert np.isfinite(out["float32"]).all()
    np.testing.assert_array_equal(out["int16"], out["float32"])
    np.testing.assert_array_equal(out["float32"],
                                  _ingest_clf(model, 4).logits(clips))


@pytest.mark.parametrize("wave_dtype", ["float32", "int16"])
def test_classify_paths_slots_are_pinned(cuda, tmp_path, wave_dtype):
    paths, _ = _wav_corpus(tmp_path, 3)
    clf = _ingest_clf(_full_st(3, cuda), 2, wave_dtype=wave_dtype)
    labels, probs = clf.classify_paths(paths)
    pf = clf._pf
    assert pf.depth == clf.MAX_IN_FLIGHT + 2
    assert all(w.is_pinned() and w.dtype == getattr(torch, wave_dtype)
               for w in pf.waves)
    assert all(x.is_pinned() for x in pf.lengths)
    assert labels.shape == (3,) and np.allclose(probs.sum(-1), 1.0)
    clf.close()


def test_classify_paths_slot_reuse_matches_classify(cuda, tmp_path):
    """12 batches through the ring's 6 slots: every slot is refilled while
    copies and compute of earlier batches are in flight; the logits equal
    logits() on the same clips in memory."""
    paths, clips = _wav_corpus(tmp_path, 12 * 8 - 3, seed=9)
    model = _full_st(3, cuda)
    clf = _ingest_clf(model, 8, wave_dtype="int16")
    got = clf.logits_paths(paths)
    again = clf.logits_paths(paths[:20])  # the ring reused by a later call
    clf.close()
    ref = _ingest_clf(model, 8).logits(clips)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(again, ref[:20])


def test_from_checkpoint_serves_on_the_card(cuda, tmp_path):
    """A training checkpoint (step_*.pt + reference_config.json) served
    through K1-K3 from WAV files, equal to the in-memory path."""
    from pcaudio_torch.checkpoint import save_checkpoint
    from pcaudio_torch.core import ExperimentConfig
    from pcaudio_torch.train import TrainState

    ref_cfg = {"architecture": "3ST (Set Transformer Temporal)",
               "window_size": 1024, "hop_factor": 0.5, "trim_dB": 60,
               "sampling_rate": 44100, "classes": 10, "dhidden": 64,
               "nheads": 8, "ninds": 64, "Ntemp": 10, "np_seed": 1}
    model = _full_st(3, "cpu")
    state = TrainState(model, torch.optim.Adam(model.parameters()))
    save_checkpoint(str(tmp_path / "ckpt"), state,
                    ExperimentConfig.from_reference_json(ref_cfg), step=3)
    clf = AudioClassifier.from_checkpoint(str(tmp_path / "ckpt"), top_k=128,
                                          batch_size=4, buffer_len=65536,
                                          device="cuda", wave_dtype="int16")
    paths, clips = _wav_corpus(tmp_path, 6, seed=10)
    counts = fused_st_forward.launches
    got = clf.logits_paths(paths)
    assert fused_st_forward.launches > counts
    clf.close()
    np.testing.assert_array_equal(got, clf.logits(clips))
    ref = AudioClassifier(model=model, pipeline=clf.pipeline, batch_size=4,
                          buffer_len=65536, device="cuda").logits(clips)
    np.testing.assert_array_equal(got, ref)


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
        kernel, plain = c.check
        wrong_kernel = {
            "one step short": lambda: (
                lane_width.chain_check(lambda x, w, reps, grid: probe_chain(x, w, reps - 1, grid),
                                       c.check_args)
                if case.startswith("chain") else
                probe_exp_chain(*kernel.__defaults__, lane_width.CHECK_EXP_REPS - 1,
                                lane_width.GRID)),
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


# the wgmma kernels of P1, P2 and P3 at the probes' full sizes: P2b
# [1024 + 8·15, 512] · [512, 512], 16 windows, 256 repeats; P2c
# [1024 + 8·63, 128] · [128, 128], 64 windows, 256 repeats
FULL_MATMULS = {"P2b": (1024, 512, 512, 16), "P2c": (1024, 128, 128, 64)}


def _windowed_operands(name, dtype, gen, cuda, low=-4, high=4):
    M, K, N, reps = FULL_MATMULS[name]
    a = torch.randint(low, high, (M + 8 * (reps - 1), K), generator=gen, device=cuda)
    b = torch.randint(low, high, (K, N), generator=gen, device=cuda)
    return a.to(dtype), b.to(dtype), reps


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("name", list(FULL_MATMULS))
def test_probe_matmul_full_size(cuda, name, dtype):
    """Integer operands in [-4, 4): exact (int8 and bf16 alike); N(0, 1)
    bf16 within matmul_bound."""
    gen = torch.Generator(cuda).manual_seed(11)
    a, b, reps = _windowed_operands(name, dtype, gen, cuda)
    got = probe_matmul(a, b, reps, 8, 256)
    ref = probe_matmul_plain(a, b, reps, 8, 256)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    if dtype == torch.bfloat16:
        a = torch.randn(a.shape, generator=gen, device=cuda).bfloat16()
        b = torch.randn(b.shape, generator=gen, device=cuda).bfloat16()
        _within(probe_matmul(a, b, reps, 8, 256), probe_matmul_plain(a, b, reps, 8, 256),
                matmul_bound(a, b, reps, 8, 256), f"{name} bf16 N(0, 1)")


def test_probe_matmul_s8_runs_are_bitwise_equal(cuda):
    """s32 atomics in any order give one sum: two runs of P2b on int8
    operands over the whole range (the sums wrap alike) are equal."""
    gen = torch.Generator(cuda).manual_seed(12)
    a, b, reps = _windowed_operands("P2b", torch.int8, gen, cuda, -128, 128)
    first = probe_matmul(a, b, reps, 8, 256)
    assert torch.equal(first, probe_matmul(a, b, reps, 8, 256))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_probe_attend_full_steps(cuda, mode):
    """P3 at the script's 1,024 grid steps, within attend_bound."""
    gen = torch.Generator(cuda).manual_seed(13)
    iq = 1.5 * torch.randn(1024, 128, generator=gen, device=cuda)
    kmat = 1.2 * torch.randn(2 * 8 * 128, 128, generator=gen, device=cuda)
    _within(probe_attend(iq, kmat, mode), probe_attend_plain(iq, kmat, mode),
            attend_bound(iq, kmat, mode), f"{mode} at 1024 steps")


@pytest.mark.parametrize("a_shape,b_shape,what", [
    ((128, 1024), (1024, 128), "ring"),          # bf16 B panel [1024, 128]: no room
    ((192, 64), (64, 128), "multiples"),         # M
    ((128, 64), (64, 192), "multiples"),         # N
    ((128, 40), (40, 128), "multiples"),         # K: 80 bytes
])
def test_probe_matmul_refuses_shapes_its_tiles_do_not_take(cuda, a_shape, b_shape, what):
    a = torch.zeros(a_shape, dtype=torch.bfloat16, device=cuda)
    b = torch.zeros(b_shape, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match=what):
        probe_matmul(a, b)


@pytest.mark.parametrize("case,wrong", [
    ("big int8", "one window short"), ("attend bf16", "one repeat short"),
    ("bf16", "half the steps"), ("int8", "half the steps")])
def test_probe_checks_catch_a_wrong_kernel(cuda, case, wrong):
    """The probes' own checks (chip_smoke phase 8), given the kernel, pass;
    given the GEMM run one window or one repeat short, or the attend over
    half its grid steps, raise.  (One attend step of 1,024 moves each
    output by less than attend_bound, which sums 8,320 f32 roundings and
    the bf16 or a8 flips of every attend.)"""
    from pcaudio_torch.probes import int8_attend, int8_matmul
    from pcaudio_torch.probes.timing import measure, tf32_off
    gen = torch.Generator(cuda).manual_seed(0)
    mod = int8_attend if wrong == "half the steps" else int8_matmul
    with tf32_off():
        c = {c.name: c for c in mod.cases(cuda, gen)}[case]
        c.iters = c.plain_iters = 1
        c.library = None
        measure(c)
        if wrong == "half the steps":
            iq, kmat, mode, pairs, keys, steps = c.args
            wrong_kernel = lambda: probe_attend(iq, kmat, mode, pairs, keys, steps // 2)
        else:
            a, b, reps, shift, repeats = c.args
            wrong_kernel = {
                "one window short": lambda: probe_matmul(a[:-shift], b, reps - 1, shift,
                                                         repeats),
                "one repeat short": lambda: probe_matmul(a, b, reps, shift, repeats - 1),
            }[wrong]
        c.check = (wrong_kernel, c.plain)
        with pytest.raises(AssertionError, match="outside its bound"):
            measure(c)


# ---- the K3-family probe kernels (csrc/probe_stream.cu, csrc/probe_featurize.cu)

from pcaudio_torch.ops.kernels.featurize_probes import (  # noqa: E402
    chunk_relayout, chunk_relayout_plain, dft_mag2, dft_mag2_bound, dft_mag2_plain,
    dft_written, int16_gram, int16_gram_plain, wave_block_sums, wave_block_sums_plain)


@pytest.mark.parametrize("n,L", [(64, 512), (5, 37), (1, 1), (130, 4096), (3, 5000)],
                         ids=["script", "ragged", "one", "wide", "past 4096"])
def test_probe_int16_gram_matches_plain(cuda, n, L):
    """P6a: int16 → f32·(1/32768) is exact; the f32 products within
    matmul_bound (2·(L + 1)·2^-24·Σ|a||b|); ragged tiles and rows, and K
    past one staged chunk."""
    gen = torch.Generator(cuda).manual_seed(0)
    x = torch.randint(-32768, 32767, (n, L), generator=gen, device=cuda, dtype=torch.int16)
    n0 = int16_gram.launches
    got = int16_gram(x)
    torch.cuda.synchronize()
    assert int16_gram.launches == n0 + 1
    xf = x.float() / 32768
    _within(got, int16_gram_plain(x), matmul_bound(xf, xf.t()), "int16 gram")


@pytest.mark.parametrize("shape", [(512, 432, 512), (3, 5, 24)], ids=["script", "small"])
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
def test_probe_wave_sums_match_plain(cuda, shape, dtype):
    """P6b on integers in [-4, 4): every partial sum is an integer below
    2^24, so the sums are exact in any order; zeros give zeros."""
    gen = torch.Generator(cuda).manual_seed(1)
    x = torch.randint(-4, 4, shape, generator=gen, device=cuda, dtype=dtype)
    n0 = wave_block_sums.launches
    got = wave_block_sums(x)
    torch.cuda.synchronize()
    assert wave_block_sums.launches == n0 + 1
    ref = wave_block_sums_plain(x)
    assert bool((ref[:, 0] != 0).any()) and torch.equal(got, ref)
    z = torch.zeros(shape, dtype=dtype, device=cuda)
    assert torch.equal(wave_block_sums(z), torch.zeros(shape[0], 2, device=cuda))


@pytest.mark.parametrize("B,C,Nt,F", [(512, 43, 10, 512), (3, 5, 4, 96)],
                         ids=["script", "small"])
@pytest.mark.parametrize("reshape", [False, True])
def test_probe_relayout_matches_plain(cuda, B, C, Nt, F, reshape):
    """P7: x + 1 is exact, and both layouts hold the same bytes."""
    gen = torch.Generator(cuda).manual_seed(2)
    x = torch.randn(B, C * Nt, F, generator=gen, device=cuda)
    n0 = chunk_relayout.launches
    got = chunk_relayout(x, C, Nt, reshape)
    torch.cuda.synchronize()
    assert chunk_relayout.launches == n0 + 1
    ref = chunk_relayout_plain(x, C, Nt, reshape)
    assert got.shape == ref.shape and torch.equal(got, ref)


DFT_FORMS = [("direct", 1, False), ("direct", 4, False), ("direct", 2, True),
             ("direct", 8, True), ("shift", 1, False), ("shift", 2, False),
             ("shift_nozero", 1, False), ("aligned", 1, False)]


def _dft_inputs(cuda, B, R, hop, F, s0_high, seed=3):
    gen = torch.Generator(cuda).manual_seed(seed)
    x3 = (0.1 * torch.randn(B, R * hop, generator=gen, device=cuda)).view(B, R, hop)
    w0, w1 = (torch.randn(hop, 2 * F, generator=gen, device=cuda).bfloat16()
              for _ in range(2))
    s0 = torch.randint(0, s0_high, (B,), generator=gen, device=cuda, dtype=torch.int32)
    s0[:2] = torch.tensor([0, s0_high - 1], dtype=torch.int32)
    return x3, w0, w1, s0


@pytest.mark.parametrize("B,R,hop,F,C,Nt,s0_high", [
    (8, 21, 64, 128, 5, 4, 16),            # one row tile a clip
    (8, 300, 128, 128, 29, 10, 40),        # three tiles, 290 of 299 frames
    (32, 431, 512, 512, 43, 10, 40),       # the scripts' widths, 32 clips
], ids=["small", "mid", "script"])
@pytest.mark.parametrize("mode,G,stacked", DFT_FORMS, ids=str)
def test_probe_dft_mag2_matches_plain(cuda, B, R, hop, F, C, Nt, s0_high, mode, G,
                                      stacked):
    """P8/P9: within dft_mag2_bound (f32 sums of bf16 products in another
    order, carried through re² + im², one bf16 rounding a side) on the rows
    the kernel writes; "shift" also zeroes the rows without a source frame,
    which the plain version writes as 0."""
    x3, w0, w1, s0 = _dft_inputs(cuda, B, R, hop, F, s0_high)
    n0 = dft_mag2.launches
    got = dft_mag2(x3, w0, w1, C, Nt, mode, s0, G=G, stacked=stacked)
    torch.cuda.synchronize()
    assert dft_mag2.launches == n0 + 1
    from pcaudio_torch.probes.featurize_variants import masked
    ref = dft_mag2_plain(x3, w0, w1, C, Nt, mode, s0)
    got = masked(got, dft_written(x3, C, Nt, mode, s0))
    assert bool((ref != 0).any()) and bool(torch.isfinite(ref.float()).all())
    tol = dft_mag2_bound(x3, w0, w1, C, Nt, mode, s0)
    _within(got.float(), ref.float(), tol, f"{mode} G={G} stacked={stacked}")
    # the bound is rounding, not the size of the output
    assert float((tol / ref.float().abs().clamp_min(1e-30))[ref != 0].median()) < 0.02


@pytest.mark.parametrize("probe,case,wrong", [
    ("featurize_variants", "v2 + zeroinit + switch", "s0 off by one"),
    ("featurize_variants", "v3 switch, no zero-init", "s0 off by one"),
    ("featurize_blockc", "G=1 unrolled", "frames off by one"),
    ("featurize_blockc", "G=2 stacked", "a seam row written")])
def test_probe_dft_check_catches_a_wrong_kernel(cuda, probe, case, wrong):
    """The P8/P9 check (chip_smoke phase 8, ``timing.measure``) passes the
    kernel and raises on one that shifts the rows by one frame, or that
    writes a clip-seam frame (clip 0's last frame with clip 1's first) into
    clip 1's row 0.  The probes' inputs are drawn again from the same seed."""
    from pcaudio_torch.probes import featurize_blockc, featurize_variants
    from pcaudio_torch.probes.featurize_blockc import C, NT, R
    from pcaudio_torch.probes.timing import measure, tf32_off
    batch = 16
    mod = {"featurize_blockc": featurize_blockc, "featurize_variants": featurize_variants}[probe]
    with tf32_off():
        c = {c.name: c for c in mod.cases(cuda, torch.Generator(cuda).manual_seed(0),
                                           batch=batch)}[case]
        c.iters = c.plain_iters = 1
        measure(c)  # raises outside the bound
        gen = torch.Generator(cuda).manual_seed(0)
        x3, w0, w1 = featurize_blockc.inputs(cuda, gen, batch)
        kernel, plain = c.check or (c.kernel, c.plain)
        if wrong == "s0 off by one":
            s0 = featurize_variants.trim_starts(cuda, gen, batch)
            mode = featurize_variants.VARIANTS[case][0]
            written = dft_written(x3, C, NT, mode, s0)

            def wrong_kernel():
                return featurize_variants.masked(
                    dft_mag2(x3, w0, w1, C, NT, mode, s0 + 1), written)
        elif wrong == "frames off by one":
            def wrong_kernel():
                out = kernel().clone().view(batch, C * NT, -1)
                out[:, :-1] = out[:, 1:].clone()
                return out.view(batch, C, NT, -1)
        else:
            # frame R − 1 of clips 0 and 1 stacked is [x0[R − 1], x1[0]]
            seam = dft_mag2_plain(x3[:2].reshape(1, 2 * R, -1), w0, w1, C, NT, "shift",
                                  torch.tensor([R], dtype=torch.int32, device=cuda))
            seam = seam.view(C * NT, -1)[0]

            def wrong_kernel():
                out = kernel().clone().view(batch, C * NT, -1)
                out[1, 0] = seam
                return out.view(batch, C, NT, -1)
        c.check = (wrong_kernel, plain)
        with pytest.raises(AssertionError, match="outside its bound"):
            measure(c)


P8_FORMS = [f"G={G} {'stacked' if st else 'unrolled'}" for G, st in
            [(1, False), (2, False), (4, False), (8, False), (2, True), (4, True), (8, True)]]
P9_VARIANTS = ["v0 matmul+sq (bf16 in)", "v0f + f32->bf16 conv", "v1 + scratch+aligned read",
               "v2 + zeroinit + switch", "v3 switch, no zero-init"]


def _dft_case(cuda, probe, case, batch=None):
    from pcaudio_torch.probes import featurize_blockc, featurize_variants
    mod = {"featurize_blockc": featurize_blockc, "featurize_variants": featurize_variants}[probe]
    gen = torch.Generator(cuda).manual_seed(0)
    cases = mod.cases(cuda, gen) if batch is None else mod.cases(cuda, gen, batch=batch)
    c = {c.name: c for c in cases}[case]
    c.iters = c.plain_iters = 1
    c.library = None
    return c


@pytest.mark.parametrize("probe,case", [("featurize_blockc", n) for n in P8_FORMS]
                         + [("featurize_variants", n) for n in P9_VARIANTS], ids=str)
def test_probe_dft_full_size_within_bound(cuda, probe, case):
    """Every P8 form (B = 1024) and P9 variant (B = 512) at the scripts'
    full size, through the probe's own check (``timing.measure``: within
    dft_mag2_bound on the rows the variant writes), its launches counted."""
    from pcaudio_torch.probes.timing import measure, tf32_off
    with tf32_off():
        r = measure(_dft_case(cuda, probe, case))
    assert r["launches"] == 4 and r["max_abs_err"] <= r["tol"]  # paired_ms: 2 x (1 + 1)


@pytest.fixture(scope="module")
def wrong_dft_builds():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from pcaudio_torch.probes.probe_stages import build_dft_sources, dft_wrong_sources
    return build_dft_sources(dft_wrong_sources(), "wrong_dft_")


@pytest.mark.parametrize("wrong", ["one K stage dropped", "w0 and w1 swapped"])
@pytest.mark.parametrize("probe,case", [("featurize_blockc", "G=1 unrolled"),
                                        ("featurize_blockc", "G=8 stacked"),
                                        ("featurize_variants", "v2 + zeroinit + switch")],
                         ids=str)
def test_probe_dft_check_catches_a_wrong_build(cuda, wrong_dft_builds, probe, case, wrong):
    """The probes' check passes the kernel and raises on a build of its
    source that drops the last K stage's products, or that swaps w0 and
    w1 (``probe_stages.DFT_WRONG``)."""
    from pcaudio_torch.probes.featurize_variants import masked
    from pcaudio_torch.probes.probe_stages import dft_call
    from pcaudio_torch.probes.timing import measure, tf32_off
    with tf32_off():
        c = _dft_case(cuda, probe, case, batch=16)
        measure(c)
        x3, _, _, C, Nt, mode, s0 = c.args[:7]
        written = dft_written(x3, C, Nt, mode, s0)
        fn = wrong_dft_builds[wrong]
        c.check = (lambda: masked(dft_call(fn, *c.args), written), c.plain)
        with pytest.raises(AssertionError, match="outside its bound"):
            measure(c)


@pytest.mark.parametrize("hop,F,B,G,mode,stacked,what", [
    (64, 64, 4, 1, "direct", False, "F a multiple of 128"),
    (96, 128, 4, 1, "direct", False, "hop a multiple of 64"),
    (32, 128, 4, 1, "direct", False, "hop a multiple of 64"),
    (64, 128, 4, 3, "direct", False, "multiple of G"),
    (64, 128, 4, 2, "shift", True, "stacked rows in direct mode only"),
], ids=str)
def test_probe_dft_refuses_shapes_its_tiles_do_not_take(cuda, hop, F, B, G, mode, stacked,
                                                        what):
    x3 = torch.zeros(B, 21, hop, device=cuda)
    w = torch.zeros(hop, 2 * F, dtype=torch.bfloat16, device=cuda)
    s0 = torch.zeros(B, dtype=torch.int32, device=cuda)
    n0 = dft_mag2.launches
    with pytest.raises(ValueError, match=what):
        dft_mag2(x3, w, w, 5, 4, mode, s0, G=G, stacked=stacked)
    assert dft_mag2.launches == n0


def test_probe_dft_runs_are_bitwise_equal(cuda):
    """No atomics: each output element is one block's sum in a fixed
    order, so two runs of P8 (G = 1) and of P9's v2 agree bit for bit."""
    for probe, case in (("featurize_blockc", "G=1 unrolled"),
                        ("featurize_variants", "v2 + zeroinit + switch")):
        c = _dft_case(cuda, probe, case)
        assert torch.equal(c.kernel(), c.kernel())


def test_featurize_probe_kernels_reject_what_they_do_not_take(cuda):
    x3 = torch.zeros(4, 21, 64, device=cuda)
    w = torch.zeros(64, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of G"):
        dft_mag2(x3, w, w, 5, 4, G=3)
    with pytest.raises(ValueError, match="stacked"):
        dft_mag2(x3, w, w, 5, 4, "shift", torch.zeros(4, dtype=torch.int32, device=cuda),
                 stacked=True)
    with pytest.raises(ValueError, match="frames"):
        dft_mag2(x3, w, w, 6, 4)
    with pytest.raises(ValueError, match="128"):
        chunk_relayout(torch.zeros(2, 12, 20, device=cuda), 3, 4, True)
    with pytest.raises(ValueError, match="int16"):
        int16_gram(torch.zeros(2, 5000, dtype=torch.int32, device=cuda))


# ---- K4 on the eval sweeps' path (pcaudio_torch.eval.experiments) ----------

from pcaudio_torch.checkpoint import load_reference_pth  # noqa: E402
from pcaudio_torch.data.synthetic import synth_clip  # noqa: E402
from pcaudio_torch.eval import (  # noqa: E402
    framewise_expt1, framewise_expt2, make_cloud_classifier,
    make_fst_frame_classifier)
from pcaudio_torch.eval.experiments import _ranks_desc  # noqa: E402
from pcaudio_torch.nn import attention as st_attention  # noqa: E402
from pcaudio_torch.ops.kernels.mha import _sm_count, fwd_plan  # noqa: E402
from pcaudio_torch.train import RECIPES, prepare_framewise_data  # noqa: E402

FST_PTH = os.path.join(os.path.dirname(__file__), "..", "artifacts", "roundtrip",
                       "FST_roundtrip_net.pth")


@pytest.mark.parametrize("B,N,M,keep", [
    (4, 64, 2049, None),     # FST expt 1 at N 4096: MAB0, MAB1, PMA
    (4, 2049, 64, None),
    (4, 1, 2049, None),
    (2, 64, 5120, 1),        # 3ST expt 2: rank masks at K 1 and K = n
    (2, 64, 5120, 5120),
    (2, 1, 5120, 1),
    (2, 1, 5120, 5120),
    (1, 64, 10240, 2561),    # 3ST expt 1 at N 2048: 10 x 1024 points
], ids=lambda x: str(x))
def test_mha_forward_at_the_sweep_shapes(cuda, B, N, M, keep):
    """K4's forward vs its plain version at the shapes the sweeps give it,
    with the expt-2 engine's rank masks (``rank < K``)."""
    gen = torch.Generator(cuda).manual_seed(M + N)
    q, k, v = (torch.randn(B, r, 64, device=cuda, generator=gen) for r in (N, M, M))
    mask = None
    if keep is not None:
        mask = _ranks_desc(torch.rand(B, M, device=cuda, generator=gen)) < keep
        assert int(mask.sum()) == B * keep
    f0 = fused_mha_fwd.launches
    out, _ = fused_mha_fwd(q, k, v, mask, 8, 0.125)
    torch.cuda.synchronize()
    assert fused_mha_fwd.launches == f0 + 1
    _close_k4(out, fused_mha_plain(q, k, v, mask, 8, 0.125), "out")


def _k4_against_plain(q, k, v, mask, h=8, scale=0.125, seed=0):
    """K4's forward (one launch) vs its plain version, its lse vs the masked
    logsumexp, the backward on that out and lse vs the plain backward, and
    autograd through fused_mha vs autograd through the plain forward, all
    within K4's bound."""
    f0 = fused_mha_fwd.launches
    out, lse = fused_mha_fwd(q, k, v, mask, h, scale)
    torch.cuda.synchronize()
    assert fused_mha_fwd.launches == f0 + 1
    _close_k4(out, fused_mha_plain(q, k, v, mask, h, scale), "out")
    B, N, dv = q.shape
    logits = torch.einsum("bnhd,bmhd->bhnm", q.view(B, N, h, -1),
                          k.view(B, k.shape[1], h, -1)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], -torch.inf)
    ref = torch.logsumexp(logits, -1)
    ref = ref.masked_fill(ref == -torch.inf, torch.inf)
    assert torch.equal(torch.isinf(lse), torch.isinf(ref))
    fin = torch.isfinite(ref)
    assert bool(((lse - ref)[fin].abs() <= 1e-5 * (1 + ref[fin].abs())).all())
    g = torch.randn(q.shape, device=q.device,
                    generator=torch.Generator(q.device).manual_seed(seed))
    grads = fused_mha_bwd(q, k, v, mask, out, lse, g, h, scale)
    joint = _constant_softmax(k, v, mask)
    _close_grads(grads, fused_mha_bwd_plain(q, k, v, mask, g, h, scale), joint, "")
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (fused_mha(*leaves, mask, h, scale) * g).sum().backward()
    auto = [x.clone().requires_grad_() for x in (q, k, v)]
    (fused_mha_plain(*auto, mask, h, scale) * g).sum().backward()
    _close_grads([a.grad for a in leaves], [a.grad for a in auto], joint, "autograd ")
    return out


def _constant_softmax(k, v, mask):
    """True where no row has two distinct valid keys: at most one valid key
    a row (expt 2's K 1), or all keys and values of a sample equal (the
    trained FST's MAB1, whose 64 inducing summaries coincide).  Then dq and
    dk are zero in exact arithmetic."""
    if mask is not None and int(mask.sum(1).max()) <= 1:
        return True
    return mask is None and bool((k == k[:, :1]).all() and (v == v[:, :1]).all())


def _close_grads(got, ref, joint, what):
    """dq, dk, dv within K4's bound, each against its own scale; but where
    dq and dk are zero in exact arithmetic (``_constant_softmax``), the
    kernels' rounding noise is held against the three gradients' common
    scale, as chip_smoke.py holds the parameter gradients."""
    if joint:
        _close_k4(torch.cat([x.flatten() for x in got]),
                  torch.cat([x.flatten() for x in ref]), f"{what}dq, dk, dv")
        return
    for a, r, name in zip(got, ref, ("dq", "dk", "dv")):
        _close_k4(a, r, f"{what}{name}")


@pytest.mark.parametrize("B,N,M,keep,mag", [
    (6, 64, 1025, 1, 1),        # FST MAB0 and PMA at expt 2's rank masks
    (6, 64, 1025, 501, 1),
    (6, 64, 1025, 1025, 1),
    (6, 1, 1025, 1, 1),
    (6, 1, 1025, 501, 1),
    (6, 1, 1025, 1025, 1),
    (16, 64, 5120, None, 1),    # 3ST training at B = 16: keys split
    (16, 1, 5120, None, 1),
    (16, 64, 5120, 2561, 1),
    (5, 15, 300, None, 1),      # query counts around the 16-row warp tile
    (5, 16, 300, None, 1),
    (5, 17, 300, 100, 1),
    (5, 64, 7, None, 1),        # key counts off the 8-key group, 64-key tile
    (5, 64, 65, 33, 1),
    (6, 64, 1025, None, 8),     # logits 64 x randn's
    (6, 1, 1025, 501, 8),
    (6, 1025, 64, None, 8),
], ids=lambda x: str(x))
def test_mha_forward_redesign_cases(cuda, B, N, M, keep, mag):
    """The new forward and the backward on its lse where the design has its
    edges: rank masks, key splits, ragged row and key tiles, large logits."""
    gen = torch.Generator(cuda).manual_seed(N * 7 + M)
    q, k, v = (mag * torch.randn(B, r, 64, device=cuda, generator=gen) for r in (N, M, M))
    mask = None
    if keep is not None:
        mask = _ranks_desc(torch.rand(B, M, device=cuda, generator=gen)) < keep
        mask[-1] = False            # and a sample with no valid key
    if B == 16 and N in (1, 64):
        assert fwd_plan(B, N, M, 8, _sm_count(0)).splits > 1
    out = _k4_against_plain(q, k, v, mask)
    if mask is not None:
        assert not out[-1].any()


def test_mha_forward_key_splits_that_hold_no_key(cuda):
    """Three key splits (B = 3, 20 queries, 1100 keys) over prefix masks: the
    second and third splits of the 3-key sample, and every split of the
    empty one, hold no valid key."""
    assert fwd_plan(3, 20, 1100, 8, _sm_count(0)).splits == 3
    gen = torch.Generator(cuda).manual_seed(11)
    q, k, v = (torch.randn(3, r, 64, device=cuda, generator=gen) for r in (20, 1100, 1100))
    counts = torch.tensor([1100, 3, 0], device=cuda)
    mask = torch.arange(1100, device=cuda)[None, :] < counts[:, None]
    out = _k4_against_plain(q, k, v, mask)
    assert not out[2].any()


def _fst_attend_inputs(keep):
    """q, k, v and the mask of the trained FST's five attends on frames of
    two synthetic clips (rank masks at ``keep``, or none)."""
    cfg = RECIPES["FST"]()
    w = np.stack([synth_clip(c, 11, n=44100) for c in (2, 7)])
    data = prepare_framewise_data(w, np.full(2, 44100, np.int32), np.array([2, 7]),
                                  cfg, device="cuda")
    pts = torch.from_numpy(data["points"][:48]).cuda()
    mask = None if keep is None else _ranks_desc(pts[..., 1]) < keep
    calls = []
    kernel = st_attention.fused_mha

    def record(q, k, v, m, num_heads, scale):
        calls.append((q.detach().clone(), k.detach().clone(), v.detach().clone(), m,
                      num_heads, scale))
        return kernel(q, k, v, m, num_heads, scale)
    st_attention.fused_mha = record
    try:
        with torch.no_grad():
            _fst(True)(pts, mask)
    finally:
        st_attention.fused_mha = kernel
    assert len(calls) == 5
    return calls


@pytest.mark.parametrize("keep", [None, 501])
def test_mha_forward_on_the_trained_fst_activations(cuda, keep):
    for q, k, v, m, h, scale in _fst_attend_inputs(keep):
        _k4_against_plain(q, k, v, m, h, scale)


# ---- K4's backward: every route of bwd_plan ---------------------------------

from pcaudio_torch.ops.kernels.mha import bwd_plan  # noqa: E402


@pytest.mark.parametrize("B,N,M,pattern,h,kind,split", [
    (40, 64, 1025, "full", 8, "fewq", False),    # FST MAB0, PMA: few queries
    (40, 1, 1025, "full", 8, "fewq", False),
    (40, 1025, 64, "full", 8, "fewk", False),    # FST MAB1: few keys
    (16, 64, 5120, "full", 8, "fewq", True),     # 3ST at B = 16: the large side split
    (16, 1, 5120, "full", 8, "fewq", True),
    (16, 5120, 64, "full", 8, "fewk", True),
    (5, 64, 300, "ragged", 8, "fewq", False),    # masks, a sample with no valid key
    (5, 1, 37, "ragged", 8, "fewq", False),
    (5, 17, 300, "rank", 8, "fewq", False),
    (5, 300, 9, "ragged", 8, "fewk", False),
    (5, 300, 64, "rank", 8, "fewk", False),
    (2, 64, 1100, "ragged", 8, "fewq", True),    # splits over masked keys
    (2, 1100, 64, "ragged", 8, "fewk", True),
    (5, 33, 300, "ragged", 16, "fewq", False),   # head width 4
    (5, 70, 50, "ragged", 16, "fewk", False),
    (5, 33, 300, "ragged", 4, "fewq", False),    # head width 16
    (5, 70, 50, "ragged", 4, "fewk", False),
    (5, 100, 120, "ragged", 8, "pair", False),   # both sides above 64: the SIMT pair
    (3, 100, 120, "full", 16, "pair", False),
], ids=lambda x: str(x))
def test_mha_bwd_routes_match_plain_and_repeat_bitwise(cuda, B, N, M, pattern, h, kind,
                                                       split):
    """K4's backward on each route of ``bwd_plan`` against the plain
    backward within K4's bound (dq, dk, dv each against its own scale; a
    sample whose keys are all masked gets zeros), and two runs bitwise
    equal: no atomics, every sum in a fixed order."""
    plan = bwd_plan(B, N, M, h, _sm_count(0), 64 // h)
    assert plan.kind == kind and (plan.splits > 1) == split, plan
    gen = torch.Generator(cuda).manual_seed(B * N + M + h)
    q, k, v, g = (torch.randn(B, r, 64, device=cuda, generator=gen) for r in (N, M, M, N))
    mask = None
    if pattern == "ragged":
        counts = torch.tensor([M, M - 3, M // 2, 1, 0][:B - 1] + [0], device=cuda)
        mask = torch.arange(M, device=cuda)[None, :] < counts[:, None]
    elif pattern == "rank":
        mask = _ranks_desc(torch.rand(B, M, device=cuda, generator=gen)) < M // 3
    scale = 0.125
    out, lse = fused_mha_fwd(q, k, v, mask, h, scale)
    b0 = fused_mha_bwd.launches
    first = fused_mha_bwd(q, k, v, mask, out, lse, g, h, scale)
    again = fused_mha_bwd(q, k, v, mask, out, lse, g, h, scale)
    torch.cuda.synchronize()
    assert fused_mha_bwd.launches == b0 + 2
    for a, b, name in zip(first, again, ("dq", "dk", "dv")):
        assert torch.equal(a, b), f"{name} differs between two runs"
    ref = fused_mha_bwd_plain(q, k, v, mask, g, h, scale)
    for got, r, name in zip(first, ref, ("dq", "dk", "dv")):
        assert bool(torch.isfinite(got).all()), name
        _close_k4(got, r, name)
    if pattern == "ragged":
        assert not any(x[-1].any() for x in first)   # the sample with no valid key


def _fst(fused):
    model = ST(dim_input=2, dim_output=10, num_inds=64, dim_hidden=64,
               num_heads=8, fused_attn=fused)
    model.load_state_dict(load_reference_pth(FST_PTH))
    return model.to("cuda").eval()


def _clips(n_clips, seconds=5.0):
    L = 220672
    w = np.zeros((n_clips, L), np.float32)
    n = np.zeros(n_clips, np.int32)
    for i in range(n_clips):
        c = synth_clip(i % 10, 100 + i, n=int(seconds * 44100))
        w[i, :len(c)], n[i] = c, len(c)
    return w, n, np.arange(n_clips) % 10


def _recording(fn, store):
    def wrapped(*args):
        lg = fn(*args)
        store.append(lg.float())
        return lg
    return wrapped


def test_expt2_microbatch_on_both_engines(cuda):
    """One FST expt-2 microbatch (4 clips: 864 frames of 1025 points; 21 K x
    (1 + 2 runs)) with the trained FST through K4 and through the plain
    attention: the same forwards in the same order (the random draws are
    seeded per microbatch), each K4 forward's argmax equal to the plain
    one's on every row whose top-2 gap is above twice the logit deviation
    (at most 1e-3), and the counts equal but for such rows."""
    w, n, lab = _clips(4)
    logits, res = {}, {}
    for fused in (True, False):
        logits[fused] = []
        res[fused] = framewise_expt2(
            None, _recording(make_cloud_classifier(_fst(fused)), logits[fused]),
            w, n, lab, mode="cloud", nruns=2, device="cuda")
    assert len(logits[True]) == len(logits[False]) == 21 * 3
    undecided = []
    for a, b in zip(logits[True], logits[False]):
        dev = (a - b).abs().max().item()
        assert dev <= 1e-3, dev
        top2 = b.sort(dim=-1).values[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) >= 2 * dev
        assert bool((a.argmax(-1) == b.argmax(-1))[decided].all())
        undecided.append(int((~decided).sum()))
    (rnd, mx), (rnd_p, mx_p) = res[True], res[False]
    assert rnd["list_K"] == mx["list_K"] == list(range(1, 1001, 50)) + [1024]
    for j, K in enumerate(mx["list_K"]):
        slack = (undecided[3 * j] + 1e-9) / 864
        assert abs(mx["data"][K][0] - mx_p["data"][K][0]) <= slack
        slack = (sum(undecided[3 * j + 1: 3 * j + 3]) + 1e-9) / 864
        assert abs(rnd["data"][K][0] - rnd_p["data"][K][0]) <= slack


def test_expt2_kept_point_forwards_on_the_card(cuda):
    """One FST ``framewise_expt2`` call through K4 (4 clips: 864 frames of
    1025 points; 21 K x (1 + 2 runs)) runs each mask on its kept points
    alone: every forward's logits lie within 1e-4 of their RMS of the same
    mask run as a key mask over the full cloud, and the accuracies are
    those masked forwards' but for rows whose top-2 gap is within twice
    the logit deviation.  Then one engine microbatch waits for the device
    nowhere (``set_sync_debug_mode("error")``): the same classifier, whose
    first call at each shape captured it, replays every forward."""
    from pcaudio_torch.dsp import FeaturizeConfig
    from pcaudio_torch.eval.experiments import (
        _featurize, _kept, _microbatch_generator, _prefix_mask_counts, _valid_frames)
    from pcaudio_torch.ops.cloud import frame_cloud, freq_coords

    w, n, lab = _clips(4)
    model, R = _fst(True), 2
    clf = make_cloud_classifier(model)
    got = []
    rnd, mx = framewise_expt2(None, _recording(clf, got),
                              w, n, lab, mode="cloud", nruns=R, device="cuda")
    cfg = FeaturizeConfig(fs=44100, n_fft=2048, top_db=60.0, trim=True)
    wv, nv = torch.from_numpy(w).to(cuda), torch.from_numpy(n).to(cuda)
    frames, valid, labels = _valid_frames(*_featurize(_kept(wv, nv, cfg), cfg),
                                          torch.from_numpy(lab).to(cuda).long())
    frames, labels = frames[valid], labels[valid]
    rows = frames.shape[0]
    assert rows == 864 and len(got) == 21 * (R + 1)
    clouds = frame_cloud(frames, freq_coords(frames.shape[-1], 44100, device=cuda))
    noise = torch.rand((R,) + tuple(frames.shape),
                       generator=_microbatch_generator(0, 0, cuda), device=cuda)
    ranks = [_ranks_desc(frames), *_ranks_desc(noise)]
    for j, K in enumerate(mx["list_K"]):
        hits, slack = [], []
        for r, rank in enumerate(ranks):
            a = got[j * (R + 1) + r]
            assert tuple(a.shape) == (rows, 10)
            with torch.no_grad():
                b = model(clouds, rank < K)
            dev = float((a - b).abs().max())
            assert dev <= 1e-4 * float(b.pow(2).mean().sqrt()), (K, r, dev)
            top2 = b.sort(dim=-1).values[:, -2:]
            slack.append(int(((top2[:, 1] - top2[:, 0]) < 2 * dev).sum()))
            hits.append(int((b.argmax(-1) == labels).sum()))
        assert abs(mx["data"][K][0] * rows - hits[0]) <= slack[0] + 1e-6
        assert abs(rnd["data"][K][0] * rows * R - sum(hits[1:])) <= sum(slack[1:]) + 1e-6
    gen = torch.Generator(device=cuda).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            cmax, crand = _prefix_mask_counts(clf, clouds, frames, labels, None, gen,
                                              mx["list_K"], R)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cmax.shape == (21,) and crand.shape == (21, R)


def test_k4_launches_rise_during_a_sweep(cuda):
    """An expt-1 sweep through the K4 model launches K4's forward five times
    a classifier call (two ISABs' two attends, PMA), and the backward
    never."""
    w, n, lab = _clips(2, seconds=1.0)
    calls = []
    f0, b0 = fused_mha_fwd.launches, fused_mha_bwd.launches
    out = framewise_expt1(_recording(make_fst_frame_classifier(_fst(True)), calls),
                          w, n, lab, list_Fs=[44100, 22050.0], list_N=[4096, 204],
                          device="cuda")
    torch.cuda.synchronize()
    # four sweep points, each at least one classifier call
    assert len(calls) >= 4 and fused_mha_fwd.launches - f0 == 5 * len(calls)
    assert fused_mha_bwd.launches == b0
    assert all(0.0 <= a <= 1.0 for v in out["data"].values() for a in v)


def _counted(fn):
    """``fn()`` and what it added to the program's counters, which count
    only while a profiler records (a CPU-only one here)."""
    from torch.profiler import ProfilerActivity, profile
    from pcaudio_torch.utils import profiling

    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, {k: v - before.get(k, 0) for k, v in profiling.counters().items()}


@pytest.mark.parametrize("K", [1, 51, 1024])
def test_cloud_classifier_replays_the_eager_forward_bitwise(cuda, K):
    """The sweep's cloud classifier at an expt-2 shape, 864 clouds of
    ``K`` kept points: the call that captures the shape and the calls that
    replay it give the eager forward's logits bit for bit."""
    model = _fst(True)
    clf = make_cloud_classifier(model)
    gen = torch.Generator(cuda).manual_seed(K)
    xs = [torch.randn(864, K, 2, device=cuda, generator=gen) for _ in range(3)]
    with torch.no_grad():
        want = [model(x) for x in xs]
        got = [clf(x) for x in xs]
    for a, b in zip(got, want):
        assert a.shape == (864, 10) and torch.equal(a, b)


def test_replayed_logits_keep_their_values(cuda):
    """Logits a replay returned are the caller's: later replays at the same
    shape and at another shape leave them as they were."""
    model = _fst(True)
    clf = make_cloud_classifier(model)
    gen = torch.Generator(cuda).manual_seed(5)
    a, b = (torch.randn(864, 51, 2, device=cuda, generator=gen) for _ in range(2))
    c = torch.randn(864, 1024, 2, device=cuda, generator=gen)
    with torch.no_grad():
        first = clf(a)
        kept = first.clone()
        second, third = clf(b), clf(c)
        want = [model(x) for x in (a, b, c)]
    assert torch.equal(first, kept) and torch.equal(first, want[0])
    assert torch.equal(second, want[1]) and torch.equal(third, want[2])
    assert not torch.equal(first, second)


def test_cloud_classifier_counts_replays_and_k4_launches(cuda):
    """``expt2.points_replayed`` counts the points of each replayed call and
    ``expt2.points_run`` those of every call; a call with a key mask or with
    gradients runs eagerly (its logits the eager forward's, the latter with
    a graph for autograd).  K4's forward counts five launches a forward:
    the capture's eager warm-up and its first replay, then each replay."""
    model = _fst(True)
    clf = make_cloud_classifier(model)
    gen = torch.Generator(cuda).manual_seed(7)
    x = torch.randn(864, 51, 2, device=cuda, generator=gen)
    mask = torch.rand(864, 51, device=cuda, generator=gen) < 0.5
    mask[:, 0] = True
    f0 = fused_mha_fwd.launches
    with torch.no_grad():
        clf(x)
    torch.cuda.synchronize()
    assert fused_mha_fwd.launches - f0 == 2 * 5

    def calls():
        with torch.no_grad():
            out = [clf(x), clf(x, mask)]
        return out + [clf(x)]

    f1 = fused_mha_fwd.launches
    (replayed, masked, graded), delta = _counted(calls)
    torch.cuda.synchronize()
    assert fused_mha_fwd.launches - f1 == 3 * 5
    assert delta["expt2.points_run"] == 3 * 864 * 51
    assert delta["expt2.points_replayed"] == 864 * 51
    assert not replayed.requires_grad and graded.requires_grad
    with torch.no_grad():
        assert torch.equal(masked, model(x, mask))
        assert torch.equal(replayed, model(x))
    assert torch.equal(graded.detach(), replayed)


def test_cloud_classifier_pool_holds_about_one_forward(cuda):
    """The 21 shapes of an FST expt-2 call (864 clouds, K rising from 1 to
    1,024) captured in the engine's order: the graphs' memory stays within
    four times one eager forward's intermediates at K 1,024 (one set a
    shape would be about ten times), and every graph, recaptured or not,
    still gives the eager logits bit for bit."""
    model = _fst(True)
    Ks = list(range(1, 1001, 50)) + [1024]
    gen = torch.Generator(cuda).manual_seed(11)
    xs = [torch.randn(864, K, 2, device=cuda, generator=gen) for K in Ks]
    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        want = [model(x) for x in xs]
        peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
        clf = make_cloud_classifier(model)
        first = [clf(x) for x in xs]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        pool = torch.cuda.memory_reserved() - held
        again = [clf(x) for x in xs]
    assert pool <= 4 * peak, (pool, peak)
    for a, b, c in zip(first, again, want):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_expt2_replayed_sweep_equals_the_eager_one(cuda):
    """A whole ``framewise_expt2`` call (4 clips: 864 frames; 21 K x (1 + 2
    runs)) through the replaying classifier gives the eager model's logits
    bit for bit and the same dicts, and every forward replays."""
    w, n, lab = _clips(4)
    model = _fst(True)
    logits, res, delta = {}, {}, {}
    for name, clf in (("replay", make_cloud_classifier(model)),
                      ("eager", lambda points, mask=None: model(points, mask))):
        logits[name] = []
        res[name], delta[name] = _counted(lambda: framewise_expt2(
            None, _recording(clf, logits[name]), w, n, lab, mode="cloud", nruns=2,
            device="cuda"))
    assert len(logits["replay"]) == len(logits["eager"]) == 21 * 3
    for a, b in zip(logits["replay"], logits["eager"]):
        assert torch.equal(a, b)
    assert res["replay"] == res["eager"]
    run = 864 * 3 * sum(min(K, 1025) for K in res["eager"][1]["list_K"])
    assert delta["replay"]["expt2.points_replayed"] == delta["replay"]["expt2.points_run"] == run


def _baseline(recipe, device):
    """The recipe's baseline at full width from torch_seed 0, and one batch
    of log-magnitude-like inputs."""
    from pcaudio_torch.train import RECIPES

    cfg = RECIPES[recipe]()
    torch.manual_seed(0)
    model = cfg.build_model().to(device)
    shape = (cfg.batch_size, 1025) if recipe == "FB" else (cfg.batch_size, 10, 512)
    rng = np.random.default_rng(12)
    x = torch.from_numpy((3.0 * rng.standard_normal(shape) - 8.0).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, cfg.batch_size))
    return model, x.to(device), y.to(device)


@pytest.mark.parametrize("recipe", ["FB", "CNNTemp"])
def test_baseline_card_matches_cpu(cuda, recipe):
    """One batch at full width, dropout off: the loss within 1e-5 relative
    and the gradient vector within 1e-4 of its largest entry, card against
    CPU."""
    res = {}
    for dev in ("cpu", cuda):
        model, x, y = _baseline(recipe, dev)
        loss = torch.nn.functional.cross_entropy(model.eval()(x), y)
        loss.backward()
        res[str(dev)] = loss.item(), torch.cat(
            [p.grad.flatten().cpu() for p in model.parameters()])
    (lc, gc), (lg, gg) = res["cpu"], res["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    err = (gg - gc).abs().max().item()
    assert err <= 1e-4 * gc.abs().max().item(), err


def test_cnn_output_ignores_cudnn_tf32(cuda):
    """CNN_temp's convolution is a matrix product: with cuDNN's TF32 flag
    on (PyTorch's default) the output is bit for bit the output with it
    off, and within 1e-5 relative of the CPU's."""
    model, x, _ = _baseline("CNNTemp", cuda)
    model.eval()
    flag = torch.backends.cudnn.allow_tf32
    try:
        with torch.no_grad():
            torch.backends.cudnn.allow_tf32 = True
            on = model(x)
            torch.backends.cudnn.allow_tf32 = False
            off = model(x)
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    assert torch.equal(on, off)
    with torch.no_grad():
        ref = model.cpu()(x.cpu())
    err = (on.cpu() - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err


@pytest.mark.parametrize("B,N,heads", [(12, 1214, 12), (12, 63, 12), (12, 64, 12),
                                       (12, 1025, 12), (1, 1214, 132), (3, 200, 2)])
def test_k5_matches_plain(cuda, B, N, heads):
    """K5 against its plain twin and the f32 softmax of the same bf16
    operands, at the AST's 1,214 tokens and at tails of 63, 64 and 1,025
    keys, with at least as many (clip, head) pairs as SMs (and one run of
    fewer); a wrong scale is told apart."""
    from pcaudio_torch.ops.kernels.attn import attn_fwd, attn_fwd_plain

    g = torch.Generator(device=cuda).manual_seed(N)
    qkv = (2.0 * torch.randn(B, N, 3 * heads * 64, device=cuda, generator=g)).to(torch.bfloat16)
    before = attn_fwd.launches
    got = attn_fwd(qkv, heads, 0.125)
    torch.cuda.synchronize()
    assert attn_fwd.launches == before + 1
    plain = attn_fwd_plain(qkv, heads, 0.125)
    x = qkv.float().reshape(B, N, 3, heads, 64).permute(2, 0, 3, 1, 4)
    want = torch.cat([(torch.softmax(x[0][i:i + 2] @ x[1][i:i + 2].transpose(-1, -2) * 0.125, -1)
                       @ x[2][i:i + 2]) for i in range(0, B, 2)]
                     ).transpose(1, 2).reshape(B, N, heads * 64)
    scale = want.abs().max().item()
    assert torch.isfinite(got.float()).all()
    # both round P and the output to bf16 (the kernel against running
    # maxima); 1.2e-2 of the largest output, as the CPU test of the twin
    assert (got.float() - plain.float()).abs().max().item() < 1.2e-2 * scale
    assert (got.float() - want).abs().max().item() < 1.2e-2 * scale
    wrong = attn_fwd_plain(qkv, heads, 0.125 / 2 ** 0.5)
    assert (got.float() - wrong.float()).abs().max().item() > 1.2e-2 * scale
    # the kernel is deterministic
    assert torch.equal(attn_fwd(qkv, heads, 0.125), got)


def test_k5_refuses_what_it_does_not_take(cuda):
    from pcaudio_torch.ops.kernels.attn import attn_fwd

    with pytest.raises(ValueError):
        attn_fwd(torch.zeros(2, 8, 3 * 2 * 64, device=cuda), 2, 0.125)   # f32
    with pytest.raises(ValueError):
        attn_fwd(torch.zeros(2, 8, 3 * 2 * 32, device=cuda, dtype=torch.bfloat16), 2, 0.125)


def test_spectrogram_pipeline_kernel_matches_plain(cuda):
    """The AST's serving pipeline through K5 against its plain twin on the
    card (width 768, 12 heads, 2 layers, the published grid), and through
    ``AudioClassifier``."""
    from pcaudio_torch.eval.pipeline import (
        SpectrogramPipelineConfig, make_spectrogram_classifier)
    from pcaudio_torch.nn import AST
    from pcaudio_torch.ops.kernels.attn import attn_fwd

    torch.manual_seed(0)
    model = AST(depth=2).to(cuda).eval()
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                p.normal_(0.0, 0.02)
    g = torch.Generator(device=cuda).manual_seed(1)
    waves = 0.1 * torch.randn(4, 160000, device=cuda, generator=g)
    lengths = torch.tensor([160000, 80000, 401, 30000], device=cuda)
    cfg = SpectrogramPipelineConfig()
    before = attn_fwd.launches
    got = make_spectrogram_classifier(model, cfg)(waves, lengths)
    assert attn_fwd.launches == before + 2
    plain = make_spectrogram_classifier(model, cfg, plain=True)(waves, lengths)
    dev = (plain - plain.mean(0)).pow(2).mean().sqrt().item()
    assert got.shape == (4, 527) and got.dtype == torch.float32
    assert (got - plain).abs().max().item() < 0.25 * dev
    clf = AudioClassifier(model=model, pipeline=cfg, batch_size=4, buffer_len=160000,
                          device="cuda")
    clips = [waves[i, :int(n)].cpu().numpy() for i, n in enumerate(lengths.tolist())]
    out = torch.from_numpy(clf.logits(clips))
    assert (out - got.cpu()).abs().max().item() < 0.25 * dev
