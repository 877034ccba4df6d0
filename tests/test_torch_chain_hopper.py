"""P4a's chain kernel (``csrc/probe_mma.cu::chain_kernel``), redesigned with
wgmma: its plan, a model of its data path, and on the card the kernel
itself.

On the CPU (no card, no nvcc), with the constants and index expressions
read from the source:

- ``chain_plan`` runs every (64-row tile, repeat) of the chain exactly once,
  in contiguous runs that differ by at most one unit, with at most
  ``CHAIN_BLOCKS_PER_SM`` blocks an SM, and refuses what the tiles do not
  take;
- w lands from TMA (one 64-column box a half, 128-byte swizzle) where the
  MN-major descriptor of every k16 step reads it;
- a model of the kernel (x loaded as wgmma A fragments, each step's
  accumulators packed into the next step's A, the repeat sums in the
  accumulator layout, flushed at a tile change) walks the plan's runs and
  equals ``probe_chain_plain`` exactly at a signed permutation and on
  ``rounding_chain_inputs``; a model with the pack's index map, its
  rounding (truncation) or the step count wrong does not;
- ``rounding_chain_inputs`` keep every step's sums exact in f32 and make
  every step round to bf16;
- the stage-split and wrong-build edits apply to the source.

On the card (marked ``cuda``; skipped here): the kernel equals the plain
version bit for bit at the signed permutation over d, n, repeats and
reps, and on the rounding inputs; builds of the source that drop the last
step, skip the pack or truncate in it fail the lane-width probe's check;
two runs are bitwise equal; and the wrapper allocates only its output (no
transposed copy of w).
"""
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from pcaudio_torch.ops.kernels import probes
from pcaudio_torch.ops.kernels.probes import (
    CHAIN_BLOCKS_PER_SM, CHAIN_ROWS, chain_plan, chain_units, probe_chain, probe_chain_plain,
    rounding_chain_inputs, signed_permutation)
from test_torch_probe_hopper import canonical, smem_desc, swizzle128

SRC = (Path(probes.__file__).resolve().parents[2] / "csrc" / "probe_mma.cu").read_text()
CHAIN = SRC[SRC.index("// ---- P4a: the dependent bf16 chain"):
            SRC.index("__global__ void exp_chain_kernel(")]


def _const(name):
    m = re.search(rf"constexpr int (?:[^;]*, )?{name} = ([^,;]+)[,;]", SRC)
    assert m, f"{name} not found"
    return int(m.group(1))


def _has(*snippets):
    """Every snippet lies in the chain's source (whitespace-insensitive)."""
    flat = " ".join(CHAIN.split())
    for s in snippets:
        assert " ".join(s.split()) in flat, f"the source no longer holds {s!r}"


def test_source_constants_are_the_plan():
    assert _const("kChainRows") == CHAIN_ROWS == 64
    assert _const("kChainThreads") == 128  # one warpgroup
    assert {128: _const("kChainBlocksPerSm128"), 64: _const("kChainBlocksPerSm64")} == \
        CHAIN_BLOCKS_PER_SM
    # the shipped build: the whole chain
    assert _const("kChainLeaveOut") == 0
    _has("const long long u0 = units * blockIdx.x / blocks, "
         "u1 = units * (blockIdx.x + 1) / blocks;",
         "const int tile = (int)(u / repeats);")


# ---- (a) the plan ------------------------------------------------------

# (n, d, repeats, sms): the probe's shapes, the card tests', small grids
PLAN_SHAPES = [
    (1024, 128, 256, 132), (1024, 64, 256, 132), (64, 64, 1, 132), (64, 128, 7, 132),
    (256, 128, 16, 132), (256, 64, 7, 132), (1024, 128, 7, 132), (1024, 64, 1, 132),
    (128, 64, 3, 1), (192, 128, 5, 7), (1024, 128, 256, 7),
]


@pytest.mark.parametrize("n,d,repeats,sms", PLAN_SHAPES, ids=str)
def test_chain_plan_runs_each_chain_once(n, d, repeats, sms):
    plan = chain_plan(n, d, repeats, sms)
    assert plan.units == (n // CHAIN_ROWS) * repeats
    assert plan.blocks == min(plan.units, sms * CHAIN_BLOCKS_PER_SM[d])
    runs = [list(chain_units(plan, b, repeats)) for b in range(plan.blocks)]
    seen = Counter(u for run in runs for u in run)
    assert set(seen) == {(t, r) for t in range(n // CHAIN_ROWS) for r in range(repeats)}
    assert set(seen.values()) == {1}
    # balanced: runs differ by at most one unit, each contiguous in
    # (tile, repeat) order, so a block leaves each tile once
    sizes = {len(run) for run in runs}
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    for run in runs:
        flat = [t * repeats + r for t, r in run]
        assert flat == list(range(flat[0], flat[0] + len(flat)))


@pytest.mark.parametrize("n,d,repeats,what", [
    (1024, 32, 1, "d 64 or 128"), (1024, 96, 1, "d 64 or 128"), (100, 64, 1, "multiple of 64"),
    (0, 64, 1, "multiple of 64"), (32, 128, 1, "multiple of 64"), (64, 64, 0, "repeats"),
], ids=str)
def test_chain_plan_refuses_what_the_tiles_do_not_take(n, d, repeats, what):
    with pytest.raises(ValueError, match=what):
        chain_plan(n, d, repeats, 132)


# ---- (b) w resident as it lies ------------------------------------------

@pytest.mark.parametrize("d", [64, 128])
def test_w_read_mn_major_where_tma_puts_it(d):
    """w [K, N] lands as one box of 64 columns x d rows a half, half h at
    h·d·128, row k 128 bytes swizzled; the k16 step kk reads it MN-major
    from kk·2048 with LBO d·128 (the second half) and SBO 1024."""
    _has("constexpr uint32_t kLbo = D * hw::kSwizzleBytes;",
         "hw::tma_load_3d(sw + h * D * hw::kSwizzleBytes, &map_w, h * 64, 0, 0, &w_full);",
         "hw::smem_desc(w_u + kk * 16 * hw::kSwizzleBytes, kLbo, hw::kSbo)")
    assert "const cuuint32_t box[3] = {64, (cuuint32_t)d, 1};" in SRC
    for kk in range(d // 16):
        desc = smem_desc(kk * 16 * 128, d * 128, 1024)
        for n in range(0, d, 5):
            for k in range(16):
                lands = (n // 64) * d * 128 + swizzle128(16 * kk + k, (n % 64) * 2)
                assert canonical(desc, n, 2 * k, "MN", 2) == lands


# ---- (c) a model of the kernel -----------------------------------------

def _threads():
    t = np.arange(128)
    return t // 32, (t % 32) // 4, t % 4


def a_coords(d):
    """(row, column) of x held in A register a[kk][r], half e, of each
    thread: the kernel's load (rows 16w + g + 8 (r & 1), columns 16kk + 8
    (r >> 1) + 2q + e) — the wgmma / mma.sync A fragment."""
    w, g, q = (v[:, None, None, None] for v in _threads())
    kk = np.arange(d // 16)[None, :, None, None]
    r = np.arange(4)[None, None, :, None]
    e = np.arange(2)[None, None, None, :]
    rows = 16 * w + g + 8 * (r & 1) + 0 * kk + 0 * e
    cols = 16 * kk + 8 * (r >> 1) + 2 * q + e + 0 * w
    return rows, cols


def d_coords(d):
    """(row, column) of accumulator i of each thread (hopper.cuh: d[4j + 2h
    + e] = D[16w + g + 8h][8j + 2q + e])."""
    w, g, q = (v[:, None] for v in _threads())
    i = np.arange(d // 2)[None, :]
    j, h, e = i // 4, (i % 4) // 2, i % 2
    return 16 * w + g + 8 * h, 8 * j + 2 * q + e


def _bf16(v):
    return torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).bfloat16().float().numpy()


def _bf16_truncated(v):
    """f32 to bf16 by dropping the low 16 bits (no rounding)."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFF0000)).view(np.float32)


def pack_index(i):
    """The kernel's pack: a[i / 4][i % 4] = (acc[2i], acc[2i + 1])."""
    return (i // 4, i % 4), (2 * i, 2 * i + 1)


def model_chain(x, w, reps, repeats, sms, pack=pack_index, steps=None, rounding=_bf16):
    """The kernel's arithmetic on the plan's runs: x and w f32 arrays of bf16
    values; each step's product exact in f64, then f32 (as the wgmma's f32
    sums are at a signed permutation, one nonzero product a sum, and on
    ``rounding_chain_inputs``, two products whose sum f32 holds)."""
    n, d = x.shape
    plan = chain_plan(n, d, repeats, sms)
    ar, ac = a_coords(d)
    dr, dc = d_coords(d)
    out = np.zeros((n, d), np.float32)
    for block in range(plan.blocks):
        cur, total = None, np.zeros((128, d // 2), np.float32)
        for tile, _ in chain_units(plan, block, repeats):
            if tile != cur:
                if cur is not None:
                    np.add.at(out, (cur * 64 + dr, dc), total)
                    total[:] = 0
                cur = tile
            xt = x[tile * 64:(tile + 1) * 64]
            regs = xt[ar, ac].copy()  # [128, d/16, 4, 2]
            for _ in range(reps if steps is None else steps):
                a = np.zeros((64, d), np.float64)
                a[ar, ac] = regs
                acc = (a @ w.astype(np.float64)).astype(np.float32)[dr, dc]
                for i in range(d // 4):
                    (kk, r), (lo, hi) = pack(i)
                    regs[:, kk, r, 0] = rounding(acc[:, lo])
                    regs[:, kk, r, 1] = rounding(acc[:, hi])
            for i in range(d // 4):  # sum[2i + e] += a[i / 4][i % 4] half e
                total[:, 2 * i] += regs[:, i // 4, i % 4, 0]
                total[:, 2 * i + 1] += regs[:, i // 4, i % 4, 1]
        if cur is not None:
            np.add.at(out, (cur * 64 + dr, dc), total)
    return out


def test_model_reads_the_source_layouts():
    """The index expressions the model uses are the kernel's."""
    _has("x + ((long long)tile * kChainRows + 16 * warp + g) * D + 2 * q",
         "a[kk][r] = *reinterpret_cast<const uint32_t*>(xr + (r & 1) * 8 * D + kk * 16 + "
         "(r >> 1) * 8);",
         "a[i / 4][i % 4] = pack_bf16(acc[2 * i], acc[2 * i + 1]);",
         "const float2 v = unpack_bf16(a[i / 4][i % 4]); sum[2 * i] += v.x; "
         "sum[2 * i + 1] += v.y;",
         "out + ((long long)tile * kChainRows + 16 * warp + g) * D + 2 * q;",
         "float* p = o + h * 8 * D + 8 * j;",
         "make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1])",
         "hw::wgmma_bf16_rs<1>(acc, a[kk], db, kk ? 1u : 0u);",
         "hw::wgmma_bf16_rs_n64<1>(acc, a[kk], db, kk ? 1u : 0u);",
         "for (int s = 0; s < reps; ++s) {")
    # each A register and each accumulator holds one element of the tile
    for d in (64, 128):
        ar, ac = a_coords(d)
        assert Counter(zip(ar.ravel(), ac.ravel())) == Counter(
            {(r, c): 1 for r in range(64) for c in range(d)})
        dr, dc = d_coords(d)
        assert Counter(zip(dr.ravel(), dc.ravel())) == Counter(
            {(r, c): 1 for r in range(64) for c in range(d)})


@pytest.mark.parametrize("n,d,reps,repeats,sms", [
    (128, 64, 5, 3, 1), (192, 128, 3, 2, 1), (64, 128, 1, 1, 132), (128, 64, 4, 7, 2)],
    ids=str)
def test_model_matches_plain_at_a_signed_permutation(n, d, reps, repeats, sms):
    g = torch.Generator().manual_seed(n + d + reps)
    x = torch.randn(n, d, generator=g).bfloat16()
    w = signed_permutation(d, g)
    ref = probe_chain_plain(x, w, reps, repeats).numpy()
    got = model_chain(x.float().numpy(), w.float().numpy(), reps, repeats, sms)
    assert np.array_equal(got, ref)


def test_model_with_a_wrong_pack_or_step_count_differs():
    """The model has teeth: the pack's registers taken in another order, or
    one step fewer, give another result at the same inputs."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(128, 64, generator=g).bfloat16()
    w = signed_permutation(64, g)
    ref = probe_chain_plain(x, w, 4, 2).numpy()
    xf, wf = x.float().numpy(), w.float().numpy()
    assert np.array_equal(model_chain(xf, wf, 4, 2, 1), ref)
    swapped = lambda i: ((i // 4, i % 4), (2 * i + 1, 2 * i))  # noqa: E731
    assert not np.array_equal(model_chain(xf, wf, 4, 2, 1, pack=swapped), ref)
    halves_swapped = lambda i: ((i // 4, (i % 4) ^ 2), (2 * i, 2 * i + 1))  # noqa: E731
    assert not np.array_equal(model_chain(xf, wf, 4, 2, 1, pack=halves_swapped), ref)
    assert not np.array_equal(model_chain(xf, wf, 4, 2, 1, steps=3), ref)


# ---- (d) the rounding check inputs ------------------------------------

@pytest.mark.parametrize("d", [64, 128])
def test_rounding_inputs_round_every_step_with_exact_sums(d):
    """w = P + 2⁻⁹·Q holds bf16 values (two nonzeros a column, one ±1 and one
    ±2⁻⁹); through 64 steps every product is exact in f32 (so in any sum
    order), |x| stays in [0.7, 2.3], and every step rounds: many elements
    change under bf16 rounding, and truncation gives another value."""
    g = torch.Generator().manual_seed(d)
    x, w = rounding_chain_inputs(256, d, g)
    wf = w.float().numpy()
    assert np.array_equal(np.sort(np.abs(wf), axis=0)[-2:],
                          np.tile([[2.0 ** -9], [1.0]], (1, d)))
    assert ((wf != 0).sum(axis=0) == 2).all() and ((wf != 0).sum(axis=1) == 2).all()
    a = x.float().numpy().astype(np.float64)
    assert (np.abs(a) >= 1).all() and (np.abs(a) < 2).all()
    for _ in range(64):
        exact = a @ wf.astype(np.float64)
        f32 = exact.astype(np.float32)
        assert np.array_equal(f32.astype(np.float64), exact)
        rounded = _bf16(f32)
        assert (rounded != f32).mean() > 0.5
        assert (_bf16_truncated(f32) != rounded).mean() > 0.2
        assert (np.abs(rounded) >= 0.7).all() and (np.abs(rounded) <= 2.3).all()
        a = rounded.astype(np.float64)


@pytest.mark.parametrize("n,d,reps,repeats,sms", [
    (128, 64, 64, 3, 1), (192, 128, 5, 2, 1), (64, 128, 1, 1, 132), (128, 64, 63, 7, 2)],
    ids=str)
def test_model_matches_plain_on_the_rounding_inputs(n, d, reps, repeats, sms):
    g = torch.Generator().manual_seed(n + d + reps)
    x, w = rounding_chain_inputs(n, d, g)
    ref = probe_chain_plain(x, w, reps, repeats).numpy()
    got = model_chain(x.float().numpy(), w.float().numpy(), reps, repeats, sms)
    assert np.array_equal(got, ref)


def test_model_with_a_truncating_pack_differs_on_the_rounding_inputs_only():
    """A pack that truncates passes at the signed permutation (each
    product is already a bf16 value) and fails on the rounding inputs."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(128, 64, generator=g).bfloat16()
    w = signed_permutation(64, g)
    xf, wf = x.float().numpy(), w.float().numpy()
    assert np.array_equal(model_chain(xf, wf, 8, 2, 1, rounding=_bf16_truncated),
                          probe_chain_plain(x, w, 8, 2).numpy())
    x, w = rounding_chain_inputs(128, 64, g)
    xf, wf = x.float().numpy(), w.float().numpy()
    ref = probe_chain_plain(x, w, 8, 2).numpy()
    assert np.array_equal(model_chain(xf, wf, 8, 2, 1), ref)
    assert not np.array_equal(model_chain(xf, wf, 8, 2, 1, rounding=_bf16_truncated), ref)


# ---- (e) the stage split's and the wrong builds' edits ------------------

def test_stage_and_wrong_builds_apply_to_the_source():
    from pcaudio_torch.probes.probe_stages import CHAIN_VARIANTS, CHAIN_WRONG, chain_sources
    for edits, what in ((CHAIN_VARIANTS, "variant"), (CHAIN_WRONG, "wrong build")):
        srcs = chain_sources(edits, what)
        assert set(srcs) == set(edits)
        for name, text in srcs.items():
            assert (text == SRC) == (not edits[name]), name


# ---- (f) on the card ----------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, n, d, seed=1):
    gen = torch.Generator(cuda).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=cuda).bfloat16()
    return x, signed_permutation(d, gen, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, 63, 64])
@pytest.mark.parametrize("repeats", [1, 7, 16, 256])
@pytest.mark.parametrize("n", [64, 256, 1024])
@pytest.mark.parametrize("d", [64, 128])
def test_chain_equals_plain_at_a_signed_permutation(cuda, d, n, repeats, reps):
    x, w = _inputs(cuda, n, d)
    n0 = probe_chain.launches
    got = probe_chain(x, w, reps, repeats)
    torch.cuda.synchronize()
    assert probe_chain.launches == n0 + 1
    ref = probe_chain_plain(x, w, reps, repeats)
    assert bool((ref != 0).all()) and torch.equal(got, ref)


@pytest.fixture(scope="module")
def wrong_chain_builds():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from pcaudio_torch.probes.probe_stages import CHAIN_WRONG, build_chain_sources, chain_sources
    return build_chain_sources(chain_sources(CHAIN_WRONG, "wrong chain build"), "wrong_chain_")


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, 64])
@pytest.mark.parametrize("repeats", [7, 256])
@pytest.mark.parametrize("n", [64, 1024])
@pytest.mark.parametrize("d", [64, 128])
def test_chain_equals_plain_on_the_rounding_inputs(cuda, d, n, repeats, reps):
    """Bit for bit where every step rounds to bf16 (``rounding_chain_inputs``)."""
    x, w = rounding_chain_inputs(n, d, torch.Generator(cuda).manual_seed(3), cuda)
    got = probe_chain(x, w, reps, repeats)
    ref = probe_chain_plain(x, w, reps, repeats)
    assert bool((ref != 0).all()) and torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("wrong", ["last step dropped", "pack skipped", "pack truncates"])
@pytest.mark.parametrize("case", ["chain d=64", "chain d=128"])
def test_chain_check_catches_a_wrong_build(cuda, wrong_chain_builds, case, wrong):
    """The lane-width probe's check passes the kernel and raises on a build
    of its source that drops the chain's last step, skips its pack or
    truncates in it (``probe_stages.CHAIN_WRONG``)."""
    from pcaudio_torch.probes import lane_width
    from pcaudio_torch.probes.probe_stages import chain_call
    from pcaudio_torch.probes.timing import measure, tf32_off
    gen = torch.Generator(cuda).manual_seed(0)
    with tf32_off():
        c = {c.name: c for c in lane_width.cases(cuda, gen)}[case]
        c.iters = c.plain_iters = 1
        measure(c)
        fn = wrong_chain_builds[wrong]
        c.check = (lambda: lane_width.chain_check(lambda *a: chain_call(fn, *a),
                                                  c.check_args), c.check[1])
        with pytest.raises(AssertionError, match="outside its bound"):
            measure(c)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_chain_runs_are_bitwise_equal(cuda, d):
    """At the probe's own values (w = N(0, 1)/d) too, where f32 sums could
    differ in order: two runs agree bit for bit."""
    gen = torch.Generator(cuda).manual_seed(2)
    x = torch.randn(1024, d, generator=gen, device=cuda).bfloat16()
    w = (torch.randn(d, d, generator=gen, device=cuda) / d).bfloat16()
    for reps in (8, 64):
        assert torch.equal(probe_chain(x, w, reps, 256), probe_chain(x, w, reps, 256))


@pytest.mark.cuda
def test_chain_wrapper_makes_no_copy_of_w(cuda):
    """One allocation a call, the output: w is read as it lies."""
    x, w = _inputs(cuda, 256, 128)
    probe_chain(x, w, 4, 3)  # the build, the cached plan
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    probe_chain(x, w, 4, 3)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 1
    with pytest.raises(ValueError, match="contiguous"):
        probe_chain(x, w.t(), 4, 3)
