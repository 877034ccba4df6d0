"""The redesigned DFT kernel (``csrc/probe_featurize.cu``, P8 and P9) on the
CPU (no card, no nvcc): its plan (``featurize_probes.dft_plan``,
``dft_tile_rows``) and a model of its data path, with the constants read
from the source.

- The plan computes every useful (clip, frame, frequency) in exactly one
  unit, and each unit in exactly one persistent block, at every P8 form
  and P9 variant and at small shapes, from the wave rows the plain version
  uses; the last tile's box reads past the wave only for rows that are no
  frame (TMA's zero fill).
- The model runs the kernel's tiles at a small shape: the f32 TMA box of
  129 rows landing swizzled, the RS fragments read from it at row offsets
  0 and 1 and rounded to bf16, W's four boxes a half read MN-major through
  the descriptor, the m64n256 accumulators (re and im of one frequency in
  one thread), and the epilogue's row rules.  Its output lies within
  ``dft_mag2_bound`` of ``dft_mag2_plain`` and of the TPU scripts' kernels
  (interpret mode, as ``tests/test_torch_featurize_probes.py`` runs them),
  and it writes exactly the rows ``dft_written`` says.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pcaudio_torch.ops.kernels import featurize_probes as fp
from pcaudio_torch.ops.kernels.featurize_probes import (
    dft_mag2_bound, dft_mag2_plain, dft_plan, dft_tile_rows, dft_written)
from pcaudio_torch.probes import featurize_blockc as p8, featurize_variants as p9
from test_torch_featurize_probes import script_blockc_kernels, script_variant_kernels
from test_torch_probe_hopper import canonical, smem_desc, swizzle128

SRC = (Path(fp.__file__).resolve().parents[2] / "csrc" / "probe_featurize.cu").read_text()
HOPPER = (Path(fp.__file__).resolve().parents[2] / "csrc" / "hopper.cuh").read_text()


def _const(src, name, env):
    m = re.search(rf"constexpr int (?:[^;]*, )?{name} = ([^,;]+)[,;]", src)
    assert m, f"{name} not found"
    v = eval(m.group(1).replace("hw::", ""), {}, env)
    assert v == int(v)
    return int(v)


K = {}
for _n in ("kSwizzleBytes", "kAtomBytes", "kSbo", "kMaxSmem"):
    K[_n] = _const(HOPPER, _n, K)
for _n in ("kBM", "kBF", "kStageK", "kARows", "kABytes", "kWBox", "kWChunk", "kWHalf",
           "kStageBytes", "kStageTx", "kStages", "kImReg", "kSmem"):
    K[_n] = _const(SRC, _n, K)


def test_source_constants_are_the_plan():
    assert (fp.DFT_BM, fp.DFT_BF, fp.DFT_STAGE_K) == (K["kBM"], K["kBF"], K["kStageK"])
    assert K["kARows"] == K["kBM"] + 1                      # both halves from one box
    assert K["kStageK"] * 4 == K["kSwizzleBytes"]           # an f32 box row: one swizzle row
    assert K["kABytes"] >= K["kARows"] * 128 and K["kABytes"] % K["kAtomBytes"] == 0
    assert K["kWBox"] * 2 == K["kSwizzleBytes"] and 4 * K["kWBox"] == 2 * K["kBF"]
    assert K["kStageBytes"] % K["kAtomBytes"] == 0
    assert K["kStageTx"] == K["kARows"] * K["kStageK"] * 4 + 2 * 4 * K["kWBox"] * K["kStageK"] * 2
    assert K["kImReg"] == 4 * K["kBF"] // 8                # register j + 16 of m64n256
    assert K["kSmem"] <= K["kMaxSmem"]


# ---- (a) the plan: every useful frame once --------------------------------

SHAPES = ([("P8 " + f"G={G} {'stacked' if st else 'unrolled'}", p8.B, p8.R, p8.HOP, p8.F, G, st)
           for G, st in p8.FORMS]
          + [("P9 " + name, p9.B, p8.R, p8.HOP, p8.F, 1, False) for name in p9.VARIANTS]
          + [("small", 8, 21, 64, 128, G, st)
             for G, st in [(1, False), (2, False), (8, False), (2, True), (8, True)]]
          + [("mid", 6, 300, 128, 256, 3, True), ("one frame", 4, 2, 64, 128, 2, True)])


@pytest.mark.parametrize("name,B,R,hop,F,G,stacked", SHAPES, ids=lambda v: str(v))
def test_plan_computes_each_frame_once(name, B, R, hop, F, G, stacked):
    plan = dft_plan(B, R, hop, F, G, stacked)
    cols, tiles, groups = plan.units
    assert cols * K["kBF"] == F and groups * G == B and tiles == plan.tiles
    assert plan.nk * K["kStageK"] == hop and plan.nk % 2 == 0
    seen = torch.zeros(B * R, dtype=torch.int64)
    for bz in range(groups):
        for by in range(tiles):
            for pass_ in range(plan.passes):
                row0, clip, r, frame = dft_tile_rows(plan, by, bz, pass_)
                assert row0 >= 0
                l = torch.arange(K["kBM"])
                # frame row l reads box rows l (w0) and l + 1 (w1): the clip's
                # wave rows r and r + 1, never past the wave (no zero fill)
                assert torch.equal((row0 + l)[frame], (clip * R + r)[frame])
                assert bool((row0 + l + 1 < B * R)[frame].all())
                seen.index_add_(0, (clip * R + r)[frame], torch.ones(int(frame.sum()),
                                                                      dtype=torch.int64))
    want = (torch.arange(B * R) % R < R - 1).long()
    assert torch.equal(seen, want)


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("name,B,R,hop,F,G,stacked", SHAPES[::3], ids=lambda v: str(v))
def test_blocks_run_each_unit_once(name, B, R, hop, F, G, stacked, sms):
    """Persistent blocks, one an SM, walk the units b, b + blocks, …: each
    unit once; blocks running at once take neighbouring column blocks."""
    plan = dft_plan(B, R, hop, F, G, stacked, sms=sms)
    cols, tiles, groups = plan.units
    assert plan.blocks == min(sms, cols * tiles * groups)
    runs = [plan.block_units(b) for b in range(plan.blocks)]
    flat = [u for run in runs for u in run]
    assert len(flat) == len(set(flat)) == cols * tiles * groups
    assert all(0 <= bx < cols and 0 <= by < tiles and 0 <= bz < groups for bx, by, bz in flat)
    assert [run[0] for run in runs[:cols]] == [(bx, 0, 0) for bx in range(min(cols, plan.blocks))]


@pytest.mark.parametrize("hop,F,B,G,mode,stacked,what", [
    (64, 64, 4, 1, "direct", False, "F a multiple of 128"),
    (96, 128, 4, 1, "direct", False, "hop a multiple of 64"),
    (32, 128, 4, 1, "direct", False, "hop a multiple of 64"),
    (64, 128, 4, 3, "direct", False, "multiple of G"),
    (64, 128, 4, 2, "aligned", True, "stacked rows in direct mode only"),
], ids=str)
def test_plan_refuses_what_the_tiles_do_not_take(hop, F, B, G, mode, stacked, what):
    with pytest.raises(ValueError, match=what):
        dft_plan(B, 21, hop, F, G, stacked, mode)


def test_last_tiles_read_zeros_past_the_wave():
    """The last segment's last box runs past the wave's B·R rows at the
    scripts' shape; the rows TMA fills with zeros are no frame's."""
    for G, st in p8.FORMS:
        plan = dft_plan(p8.B, p8.R, p8.HOP, p8.F, G, st)
        row0, clip, r, frame = dft_tile_rows(plan, plan.tiles - 1, plan.units[2] - 1,
                                             plan.passes - 1)
        past = row0 + torch.arange(K["kARows"]) >= p8.B * p8.R
        assert past.any()                                     # the box runs past the end
        assert not (frame & past[:-1]).any() and not (frame & past[1:]).any()


# ---- (b) the layouts the source uses ---------------------------------------

def test_source_reads_the_layouts_the_model_uses():
    """The lines of the source that the model below follows."""
    for line in (
            "const int row = lrow + h + 8 * (r & 1);",
            "const int col = (16 * ks + 8 * (r >> 1) + 2 * q) * 4;",
            "const int col = (chunk < 2 ? f0 : p.F + f0) + (chunk % 2) * kWBox;",
            "uint8_t* dst = st + kABytes + half * kWHalf + chunk * kWChunk;",
            "const CUtensorMap* map = half ? &map_w1 : &map_w0;",
            "hw::tma_load_3d(st, &map_x, kt * kStageK, row0, 0, &full[stage]);",
            "const int lrow = cw * 64 + warp * 16 + g;",
            "bool ok = s < seg_rows && r < R - 1;",
            "ok = ok && j >= 0 && j < p.rows_out;",
            "w[e] = bf16x2(mag2(acc[i], acc[kImReg + i]), mag2(acc[i + 1], acc[kImReg + i + 1]));",
            "const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? w[0] : w[1], 1);",
            "*reinterpret_cast<uint2*>(o + 8 * (jj + odd)) =",
            "odd ? make_uint2(got, w[1]) : make_uint2(w[0], got);",
            "__nv_bfloat16* o = p.out + ((long long)b * p.rows_out + j) * p.F + f0 + 2 * (q & 2);"):
        assert line in SRC, line
    assert re.search(r"smem_desc\(wb \+ \(i / 2\) \* kWHalf \+ \(i % 2\) \* 16 \*\s*"
                     r"hw::kSwizzleBytes, kWChunk, hw::kSbo\)", SRC)
    assert "wgmma_bf16_rs_n256<1>" in SRC and "mma.sync" not in SRC


def _acc_layout():
    """wgmma m64n256 f32 accumulators: thread t (warp w, g, q), register
    4j + 2h + e holds D[16w + g + 8h][8j + 2q + e] (hopper.cuh)."""
    t = torch.arange(128)[:, None]
    i = torch.arange(128)[None, :]
    w, g, q = t // 32, (t % 32) // 4, t % 4
    row = 16 * w + g + 8 * ((i // 2) % 2)
    col = 8 * (i // 4) + 2 * q + i % 2
    return row.expand(128, 128), col.expand(128, 128)


def test_re_and_im_of_a_frequency_lie_in_one_thread():
    """Column c of the B tile is re of f0 + c (c < 128) and im of f0 + c −
    128 (the boxes' columns); register i and i + kImReg of a thread hold
    columns c and c + 128 of the same row."""
    row, col = _acc_layout()
    n = K["kImReg"]
    assert torch.equal(row[:, :n], row[:, n:]) and torch.equal(col[:, :n] + K["kBF"], col[:, n:])
    assert set(col[:, :n].flatten().tolist()) == set(range(K["kBF"]))
    F, f0 = 512, 128
    cols = _w_columns(f0, F)
    assert torch.equal(cols[:K["kBF"]], f0 + torch.arange(K["kBF"]))
    assert torch.equal(cols[K["kBF"]:], F + f0 + torch.arange(K["kBF"]))


def _w_columns(f0, F):
    """W's column of each of the B tile's 256 columns: box `chunk` holds
    columns (chunk < 2 ? f0 : F + f0) + (chunk % 2) · 64 onward."""
    return torch.cat([(f0 if ch < 2 else F + f0) + (ch % 2) * K["kWBox"]
                      + torch.arange(K["kWBox"]) for ch in range(4)])


# ---- (c) a model of the kernel at a small shape ------------------------------

def _index_maps():
    """Shared-memory element indices the kernel reads: A fragments of
    warpgroup cw, half h, k-step ks from the f32 stage ([2, 2, 2, 64, 16],
    f32 elements), and B of k-step (h, ks) from the W stage through the
    MN-major descriptor ([2, 2, 16, 256], bf16 elements of the two halves)."""
    t = torch.arange(128)
    w, g, q = t // 32, (t % 32) // 4, t % 4
    a_idx = torch.empty(2, 2, 2, 64, 16, dtype=torch.int64)
    for cw in range(2):
        lrow = cw * 64 + w * 16 + g
        for h in range(2):
            for ks in range(2):
                for r in range(4):
                    for e in range(2):
                        row = lrow + h + 8 * (r & 1)                  # box row
                        col = (16 * ks + 8 * (r >> 1) + 2 * q) * 4 + 4 * e  # byte
                        addr = torch.tensor([swizzle128(int(a), int(b))
                                             for a, b in zip(row, col)])
                        mrow = 16 * w + g + 8 * (r & 1)               # A row of the product
                        kk = 8 * (r >> 1) + 2 * q + e
                        a_idx[cw, h, ks, mrow, kk] = addr // 4
    n = np.arange(256)[None, :]
    kb = 2 * np.arange(16)[:, None]
    b_idx = torch.empty(2, 2, 16, 256, dtype=torch.int64)
    for i in range(4):
        h, ks = i // 2, i % 2
        d = smem_desc(h * K["kWHalf"] + ks * 16 * K["kSwizzleBytes"], K["kWChunk"], K["kSbo"])
        b_idx[h, ks] = torch.from_numpy(np.asarray(canonical(d, n, kb, "MN", 2)) // 2)
    return a_idx, b_idx


A_IDX, B_IDX = _index_maps()
# where TMA lands the wave's box (row i, sample k: f32 element) and W's box
# `chunk` of half h (K row u, column v: bf16 element) in a stage
A_LAND = torch.tensor([[swizzle128(i, 4 * k) // 4 for k in range(32)] for i in range(129)])
W_LAND = torch.tensor([[[[(h * K["kWHalf"] + ch * K["kWChunk"] + swizzle128(u, 2 * v)) // 2
                          for v in range(64)] for u in range(32)] for ch in range(4)]
                       for h in range(2)])


def kernel_model(x3, w0, w1, C, Nt, mode="direct", s0=None, G=1, stacked=False):
    """The kernel's output, tile by tile, NaN where it writes nothing."""
    B, R, hop = x3.shape
    F = w0.shape[1] // 2
    plan = dft_plan(B, R, hop, F, G, stacked, mode)
    rows_out = C * Nt
    flat = torch.cat([x3.reshape(B * R, hop),   # TMA's zero fill past the wave
                      torch.zeros(plan.tiles * K["kBM"] + K["kARows"], hop)])
    out = torch.full((B, rows_out, F), float("nan"))
    if mode == "direct":
        shift = torch.zeros(B, dtype=torch.int64)
    else:
        shift = (7 + s0.long()) // 8 * 8 - 8 if mode == "aligned" else s0.long() - 1
    row, col = _acc_layout()
    n = K["kImReg"]
    sk = K["kStageK"]
    for b in range(plan.blocks):
        for bx, by, bz in plan.block_units(b):
            for pass_ in range(plan.passes):
                row0, clip, r, frame = dft_tile_rows(plan, by, bz, pass_)
                clip0 = bz * G + (0 if stacked else pass_)
                f0 = bx * K["kBF"]
                if mode == "shift":  # the first and last tiles zero the rows with no source
                    j = torch.arange(rows_out)
                    if by == 0:
                        out[clip0, j[j + shift[clip0] < 0], f0:f0 + K["kBF"]] = 0.0
                    if by == plan.tiles - 1:
                        out[clip0, j[j + shift[clip0] > R - 2], f0:f0 + K["kBF"]] = 0.0
                box = flat[row0:row0 + K["kARows"]]
                wcols = _w_columns(f0, F)
                acc = torch.zeros(2, 64, 256, dtype=torch.float64)
                for kt in range(plan.nk):
                    stage = torch.zeros(K["kABytes"] // 4)
                    stage[A_LAND] = box[:, kt * sk:(kt + 1) * sk]
                    wst = torch.zeros(K["kWHalf"])
                    for half, wm in enumerate((w0, w1)):  # box i: half i / 4 (w0, w1)
                        rows = wm[kt * sk:(kt + 1) * sk].float()
                        for ch in range(4):
                            wst[W_LAND[half, ch]] = rows[:, wcols[ch * 64:(ch + 1) * 64]]
                    for cw in range(2):
                        for i in range(4):
                            h, ks = i // 2, i % 2
                            a_op = stage[A_IDX[cw, h, ks]].bfloat16().double()
                            acc[cw] += a_op @ wst[B_IDX[h, ks]].double()
                acc = acc.float()
                for cw in range(2):
                    regs = acc[cw][row, col]                        # [thread, register]
                    m2 = (regs[:, :n] * regs[:, :n] + regs[:, n:] * regs[:, n:]).bfloat16()
                    lr = cw * 64 + row[:, :n]
                    ok = frame[lr]
                    cl = clip[lr]
                    j = r[lr] - shift[cl.clamp(max=B - 1)]  # read where ok only
                    ok = ok & (j >= 0) & (j < rows_out)
                    out[cl[ok], j[ok], f0 + col[:, :n][ok]] = m2[ok].float()
    return out.reshape(B, C, Nt, F)


# the model's small shape: what the kernel takes (hop 64, F 128), R 21 so
# that C·Nt = 20 = R − 1 as at the scripts' sizes
HOP, F, NT, R, N_CLIPS = 64, 128, 4, 21, 8
C = (1 + R) // NT
S0 = np.array([0, 1, 5, 7, 8, 9, 15, 16], np.int32)
MODES = {"k_matmul": "direct", "k_matmul_f": "direct", "k_scratch": "aligned",
         "k_full": "shift", "k_nozero": "shift_nozero"}


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    waves = (0.1 * rng.standard_normal((N_CLIPS, R * HOP))).astype(np.float32)
    w0 = rng.standard_normal((HOP, 2 * F)).astype(np.float32)
    w1 = rng.standard_normal((HOP, 2 * F)).astype(np.float32)
    x3 = waves.reshape(N_CLIPS, R, HOP)
    jx = (jnp.asarray(x3), jnp.asarray(w0, dtype=jnp.bfloat16),
          jnp.asarray(w1, dtype=jnp.bfloat16))
    return jx, (torch.from_numpy(x3), torch.from_numpy(w0).bfloat16(),
                torch.from_numpy(w1).bfloat16())


def _blockc(kern, G):
    """The script's ``make(kern, G)`` at the model's shape, interpret mode."""
    return pl.pallas_call(
        kern, grid=(N_CLIPS // G,),
        in_specs=[pl.BlockSpec((G, R, HOP), lambda c: (c, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((G, C, NT, F), lambda c: (c, 0, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((N_CLIPS, C, NT, F), jnp.bfloat16),
        compiler_params=pltpu.CompilerParams(dimension_semantics=("parallel",)),
        interpret=True)


def _variant(kern, scratch):
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(N_CLIPS,),
        in_specs=[pl.BlockSpec((1, R, HOP), lambda c, s: (c, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, C, NT, F), lambda c, s: (c, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=([pltpu.VMEM((R + C * NT + 24, F), jnp.float32)] if scratch else []))
    return pl.pallas_call(
        kern, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((N_CLIPS, C, NT, F), jnp.bfloat16),
        compiler_params=pltpu.CompilerParams(dimension_semantics=("arbitrary",)),
        interpret=True)


def _hold(got, ref, tx, mode, s0, what):
    """``got`` (NaN where unwritten) writes exactly dft_written's rows, and
    there lies within dft_mag2_bound of ``ref``."""
    written = dft_written(tx[0], C, NT, mode, s0)
    assert torch.equal(~torch.isnan(got).any(-1), written), what
    assert not torch.isnan(got[written]).any(), what
    bound = dft_mag2_bound(*tx, C, NT, mode, s0)
    err = (got - ref.float()).abs()[written]
    assert bool((err <= bound[written]).all()), (what, float((err - bound[written]).max()))


@pytest.mark.parametrize("G,stacked", p8.FORMS, ids=str)
def test_model_matches_plain_and_script_blockc(G, stacked):
    """P8's forms: the model against dft_mag2_plain and against the
    script's k_unroll / k_stack (interpret mode)."""
    jx, tx = _inputs()
    got = kernel_model(*tx, C, NT, G=G, stacked=stacked)
    _hold(got, dft_mag2_plain(*tx, C, NT), tx, "direct", None, f"G={G} plain")
    kern = script_blockc_kernels(G, R, HOP, F, C, NT)[int(stacked)]
    ref = torch.from_numpy(np.asarray(_blockc(kern, G)(*jx), np.float32))
    _hold(got, ref, tx, "direct", None, f"G={G} script")


@pytest.mark.parametrize("name", list(MODES))
def test_model_matches_plain_and_script_variants(name):
    """P9's variants: the model against dft_mag2_plain and the script's
    kernel on the rows each writes; k_full's rows with no source are 0."""
    jx, tx = _inputs()
    mode, s0 = MODES[name], torch.from_numpy(S0)
    got = kernel_model(*tx, C, NT, mode, s0)
    _hold(got, dft_mag2_plain(*tx, C, NT, mode, s0), tx, mode, s0, f"{name} plain")
    kern, scratch = script_variant_kernels(R, F, C, NT)[name]
    ref = torch.from_numpy(np.asarray(_variant(kern, scratch)(jnp.asarray(S0), *jx),
                                      np.float32))
    _hold(got, ref, tx, mode, s0, f"{name} script")
    if mode == "shift":
        src = torch.arange(C * NT) + s0.long()[:, None] - 1
        none = ((src < 0) | (src > R - 2)).reshape(N_CLIPS, C, NT)
        assert none.any() and bool((got[none] == 0).all())


def test_model_catches_a_swapped_or_short_product():
    """The bound tells the model from one fed w0 and w1 swapped, or the
    wave one row off (the half-1 rows read at offset 0)."""
    _, tx = _inputs()
    ref = dft_mag2_plain(*tx, C, NT)
    bound = dft_mag2_bound(*tx, C, NT)
    swapped = kernel_model(tx[0], tx[2], tx[1], C, NT)
    assert ((swapped - ref.float()).abs() > bound).any()
    x3 = tx[0].clone()
    x3[:, 1:] = x3[:, :-1].clone()
    off = kernel_model(x3, *tx[1:], C, NT)
    assert ((off - ref.float()).abs() > bound).any()


def test_stage_and_wrong_builds_apply_to_the_source():
    """The source edits of ``probe_stages --dft-stages`` and of the card
    tests' wrong builds each apply (``apply_edits`` raises where one does
    not), and change the source."""
    from pcaudio_torch.probes.probe_stages import (
        DFT_VARIANTS, DFT_WRONG, dft_variant_sources, dft_wrong_sources)
    variants, wrong = dft_variant_sources(), dft_wrong_sources()
    assert set(variants) == set(DFT_VARIANTS) and set(wrong) == set(DFT_WRONG)
    assert variants["whole"] == SRC
    assert all(text != SRC for name, text in variants.items() if name != "whole")
    assert all(text != SRC for text in wrong.values())
