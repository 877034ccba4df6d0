"""The two wgmma probe kernels' plans and layouts, and the attend's
arithmetic, on the CPU (no card, no nvcc):

- the plans (``matmul_plan``, ``attend_plan``) at every shape of the probes
  and of the card tests cover each output element's sum exactly once;
- a model of the 128-byte swizzle and of the shared-memory matrix
  descriptor, with the constants read from ``csrc/hopper.cuh`` and the two
  kernels' sources, against the PTX ISA's canonical K-major and MN-major
  layouts: every operand element the kernels stage lies where the
  descriptor they give wgmma reads it;
- a torch emulation of the new attend's arithmetic (its bf16 and a8
  rounding points, its row-sum order, ex2 with log2 e folded into the
  scale, a = e · (1 / sum)) lies within ``attend_bound`` of the plain
  version.
"""
import math
import re
from collections import Counter
from pathlib import Path

import pytest
import torch

from pcaudio_torch.ops.kernels import probes
from pcaudio_torch.ops.kernels.probes import (
    MAX_SLAB_ROWS, SMEM_BYTES, attend_bound, attend_plan, attend_units, matmul_plan,
    matmul_units, probe_attend_plain, quant, window_of)

CSRC = Path(probes.__file__).resolve().parents[2] / "csrc"
HOPPER = (CSRC / "hopper.cuh").read_text()
MMA = (CSRC / "probe_mma.cu").read_text()
ATTEND = (CSRC / "probe_attend.cu").read_text()


def _const(src, name):
    """An integer constant of a kernel source (``constexpr int name = ...``,
    possibly one of several on a line), evaluated over the ones before."""
    m = re.search(rf"constexpr int (?:[^;]*, )?{name} = ([^,;]+)[,;]", src)
    assert m, f"{name} not found"
    return eval(m.group(1), {}, CONSTS)


CONSTS = {}
for _name in ("kSwizzleBytes", "kAtomBytes", "kSbo", "kKStepBytes", "kLayoutSwizzle128",
              "kMaxSmem"):
    CONSTS[_name] = _const(HOPPER, _name)
for _name in ("kBM", "kBN", "kMaxStages", "kMaxSlabRows", "kBBox"):
    CONSTS[_name] = _const(MMA, _name)
for _name in ("kDv", "kKeys", "kBlockRows", "kHalfBytes", "kOperandBytes", "kQBytes"):
    CONSTS[_name] = _const(ATTEND, _name)


# ---- (a) the plans cover every product once ------------------------------

# (batch, M, N, K, reps, shift, repeats, bytes an element): the probes'
# shapes (P1, P2a, P2b, P2c in both types) and the card tests'
MATMUL_SHAPES = [
    (8, 512, 128, 64, 1, 0, 1, 2), (8, 512, 128, 64, 1, 0, 1, 1),
    (1, 128, 128, 128, 1, 0, 1, 1), (1, 128, 128, 128, 1, 0, 1, 2),
    (1, 1024, 512, 512, 16, 8, 256, 1), (1, 1024, 512, 512, 16, 8, 256, 2),
    (1, 1024, 128, 128, 64, 8, 256, 1), (1, 1024, 128, 128, 64, 8, 256, 2),
    (1, 256, 256, 512, 4, 8, 3, 1), (1, 256, 256, 512, 4, 8, 3, 2),
    (1, 1024, 128, 128, 64, 8, 16, 1), (1, 1024, 128, 128, 64, 8, 16, 2),
    (1, 256, 128, 192, 5, 3, 2, 2), (3, 128, 256, 192, 1, 0, 1, 1),
]


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=str)
def test_matmul_plan_covers_each_sum_once(shape, sms):
    batch, M, N, K, reps, shift, repeats, elem = shape
    plan = matmul_plan(batch, M, N, K, reps, shift, repeats, elem, sms)
    assert plan.smem <= SMEM_BYTES == CONSTS["kMaxSmem"]
    assert 3 <= plan.stages <= CONSTS["kMaxStages"]
    assert plan.slab_rows == CONSTS["kBM"] + (plan.group - 1) * shift <= MAX_SLAB_ROWS
    assert plan.group == 1 or shift % 8 == 0  # windows whole swizzle atoms apart
    assert plan.panels * plan.blocks <= max(sms, plan.panels)
    seen = Counter()
    for block in range(plan.panels * plan.blocks):
        for panel, mt, r, windows in matmul_units(plan, block, M, repeats, reps):
            for i in windows:
                seen[panel, mt, r, i] += 1
    want = {(p, mt, r, i) for p in range(batch * N // 128) for mt in range(M // 128)
            for r in range(repeats) for i in range(reps)}
    assert set(seen) == want and set(seen.values()) == {1}
    # a block's stores are safe only where each tile is one unit
    assert plan.accumulate == (repeats * plan.groups > 1)


@pytest.mark.parametrize("shape", [
    (8, 100, 128, 64, 1, 0, 1, 2),     # M not a multiple of 128
    (1, 128, 96, 128, 1, 0, 1, 2),     # N
    (1, 128, 128, 40, 1, 0, 1, 1),     # K not 64 bytes
    (1, 128, 128, 1024, 1, 0, 1, 2),   # a B panel with no room for the ring
], ids=str)
def test_matmul_plan_refuses_what_the_tiles_do_not_take(shape):
    with pytest.raises(ValueError):
        matmul_plan(*shape, 132)


@pytest.mark.parametrize("rows,pairs,steps,sms", [
    (1024, 8, 1024, 132), (1024, 8, 32, 132), (256, 2, 3, 132), (512, 3, 5, 7)])
def test_attend_plan_covers_each_attend_once(rows, pairs, steps, sms):
    plan = attend_plan(rows, pairs, steps, sms)
    attends = steps * pairs
    seen = Counter(u for b in range(plan.blocks) for u in attend_units(plan, b, attends))
    assert CONSTS["kBlockRows"] == probes.ATTEND_ROWS
    assert set(seen) == {(rb, a) for rb in range(rows // probes.ATTEND_ROWS)
                         for a in range(attends)}
    assert set(seen.values()) == {1} and plan.blocks <= sms
    # the kernel's window of each attend is the plain version's
    _, idx = probes._windows(torch.zeros((2 * pairs - 1) * 128, 128), pairs, 128, steps)
    assert idx.tolist() == [window_of(a, pairs) for a in range(attends)]


# ---- (b) the 128-byte swizzle and the descriptor ---------------------------

def swizzle128(row, col):
    """The kernels' ``hopper::swizzle128``, evaluated from its source."""
    expr = re.search(r"uint32_t swizzle128\(uint32_t row, uint32_t col\) \{\s*return ([^;]+);",
                     HOPPER).group(1)
    return eval(expr, {}, dict(CONSTS, row=row, col=col))


def tma_swizzle(addr):
    """CU_TENSOR_MAP_SWIZZLE_128B and the descriptor's layout 1, as the
    hardware applies them to a shared address: bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def smem_desc(addr, lbo, sbo):
    """The kernels' ``hopper::smem_desc``, evaluated from its source."""
    body = re.search(r"uint64_t smem_desc\(uint32_t addr, uint32_t lbo,\s*uint32_t sbo\) \{"
                     r"\s*return ([^;]+);", HOPPER).group(1)
    body = " ".join(body.replace("(uint64_t)", "").split())
    return eval(body, {}, dict(CONSTS, addr=addr, lbo=lbo, sbo=sbo))


def desc_fields(desc):
    """The PTX ISA's fields of a shared-memory matrix descriptor."""
    return {"start": (desc & 0x3FFF) << 4, "lbo": ((desc >> 16) & 0x3FFF) << 4,
            "sbo": ((desc >> 32) & 0x3FFF) << 4, "base_offset": (desc >> 49) & 7,
            "layout": desc >> 62}


def canonical(desc, mn, k_byte, major, elem=2):
    """Where wgmma reads element (mn, k) of an operand (k as a byte offset
    into the instruction's 32 bytes of K): the PTX ISA's canonical layouts
    for the 128-byte swizzle (CUTLASS's GmmaDescriptor, in 16-byte units:
    K-major ((8, m), (T, 2)) : ((8T, SBO), (1, T)); MN-major
    ((T, 8, m), (8, k)) : ((1, T, LBO), (8T, SBO))), then the swizzle."""
    f = desc_fields(desc)
    assert f["layout"] == 1 and f["base_offset"] == 0
    if major == "K":
        addr = f["start"] + (mn // 8) * f["sbo"] + (mn % 8) * 128 + k_byte
    else:
        k = k_byte // elem
        addr = (f["start"] + (mn // (128 // elem)) * f["lbo"] + (k // 8) * f["sbo"]
                + (k % 8) * 128 + (mn % (128 // elem)) * elem)
    return tma_swizzle(addr)


def test_swizzle_is_the_hardware_pattern():
    for row in range(16):
        for col in range(128):
            assert swizzle128(row, col) == tma_swizzle(row * 128 + col)
    assert CONSTS["kSwizzleBytes"] == 128 and CONSTS["kAtomBytes"] == CONSTS["kSbo"] == 1024


def test_descriptor_fields_are_the_ptx_isa_layout():
    d = smem_desc(0x12340, 81920, 1024)
    assert desc_fields(d) == {"start": 0x12340, "lbo": 81920, "sbo": 1024,
                              "base_offset": 0, "layout": 1}
    assert CONSTS["kLayoutSwizzle128"] == 1 and CONSTS["kKStepBytes"] == 32


@pytest.mark.parametrize("elem", [2, 1])
def test_gemm_a_slab_windows_read_what_tma_wrote(elem):
    """A's slab lands from TMA at base + swizzle(row, byte); window i of
    warpgroup cw at k-step ks reads from start base + (i·shift + 64 cw)·128
    + 32 ks (K-major, SBO 1024): the same element."""
    base, shift = 3 * 1024, 8
    for i in (0, 1, 7):
        for cw in (0, 1):
            for ks in range(4):
                start = base + (i * shift + 64 * cw) * 128 + ks * CONSTS["kKStepBytes"]
                d = smem_desc(start, 16, CONSTS["kSbo"])
                for m in range(0, 64, 5):
                    for kb in range(0, 32, 3):
                        row, col = i * shift + 64 * cw + m, 32 * ks + kb
                        assert canonical(d, m, kb, "K", elem) == base + swizzle128(row, col)


def test_gemm_bf16_b_panel_read_mn_major():
    """bf16 B [K, N] through TMA boxes of 64 columns x kBBox rows: half h
    at h·KP·128, rows k·128 swizzled; the k16 step q reads it MN-major
    from q·2048 with LBO KP·128 (the second half) and SBO 1024."""
    kp, box = 192, CONSTS["kBBox"]
    assert box == 64
    assert re.search(r"b_lbo = p\.KP \* hw::kSwizzleBytes", MMA)
    assert re.search(r"smem_desc\(b_u \+ q \* 16 \* hw::kSwizzleBytes, b_lbo, hw::kSbo\)", MMA)
    for q in range(kp // 16):
        d = smem_desc(q * 16 * 128, kp * 128, CONSTS["kSbo"])
        for n in range(0, 128, 7):
            for kk in range(16):
                k = 16 * q + kk
                h, kb = n // 64, k // box
                lands = h * kp * 128 + kb * box * 128 + swizzle128(k % box, (n % 64) * 2)
                assert canonical(d, n, 2 * kk, "MN", 2) == lands


def test_gemm_s8_b_panel_read_k_major():
    """s8 B staged by the threads: k in region k / 128 (128 rows of 128
    bytes), row n, byte k % 128 swizzled; the k32 step q reads it K-major
    from (q / 4)·16384 + (q % 4)·32."""
    src = re.search(r"sb \+ \(kc / 8\) \* \(kBN \* hw::kSwizzleBytes\) \+\s*"
                    r"hw::swizzle128\(n, \(kc % 8\) \* 16\)", MMA)
    assert src, "the s8 staging's address changed"
    for q in range(8):
        d = smem_desc((q // 4) * 128 * 128 + (q % 4) * 32, 16, CONSTS["kSbo"])
        for n in range(0, 128, 3):
            for kb in range(32):
                k = 32 * q + kb
                lands = (k // 128) * 128 * 128 + swizzle128(n, k % 128)
                assert canonical(d, n, kb, "K", 1) == lands


def test_attend_bf16_copy_serves_both_products():
    """The bf16 window [key][dv] in two halves of 64 dv: S reads it as a
    K-major B (N = keys, K = dv), A.V as an MN-major B (N = dv, K = keys,
    LBO = one half)."""
    half = CONSTS["kKeys"] * 128
    assert 2 * half == CONSTS["kOperandBytes"]
    assert re.search(r"smem_desc\(op \+ kk \* 16 \* hw::kSwizzleBytes,\s*"
                     r"kKeys \* hw::kSwizzleBytes, hw::kSbo\)", ATTEND)
    lands = {(j, dv): (dv // 64) * half + swizzle128(j, (dv % 64) * 2)
             for j in range(128) for dv in range(128)}
    for kk in range(8):  # S: k16 over dv
        d = smem_desc((kk // 4) * half + (kk % 4) * 32, 16, CONSTS["kSbo"])
        for j in range(0, 128, 5):
            for kb in range(0, 32, 2):
                assert canonical(d, j, kb, "K", 2) == lands[j, 16 * kk + kb // 2]
    for kk in range(8):  # A.V: k16 over keys
        d = smem_desc(kk * 16 * 128, half, CONSTS["kSbo"])
        for dv in range(0, 128, 3):
            for kr in range(16):
                assert canonical(d, dv, 2 * kr, "MN", 2) == lands[16 * kk + kr, dv]


def _s8_position(t):
    expr = re.search(r"constexpr int s8_position\(int t\) \{\s*return ([^;]+);", ATTEND)
    return eval(expr.group(1), {}, {"t": t})


def test_attend_int8_permutation_matches_the_accumulators():
    """The int8 A.V takes a8 packed from the logits' accumulators as A in
    registers: thread q's register r of k32 step kk holds keys 32kk +
    16(r / 2) + {2q, 2q+1, 8+2q, 9+2q} at bytes 0-3, which the PTX ISA's
    s8 A layout puts at k positions 32kk + 16(r / 2) + 4q + 0..3; the
    dv-major copy puts key t of each 16 at position s8_position(t)."""
    assert sorted(_s8_position(t) for t in range(16)) == list(range(16))
    for q in range(4):
        for byte, t in enumerate((2 * q, 2 * q + 1, 8 + 2 * q, 9 + 2 * q)):
            assert _s8_position(t) == 4 * q + byte


# ---- (c) the attend's arithmetic, emulated --------------------------------

LOG2E = 1.4426950408889634
F32 = torch.float32


def _f32(x):
    return torch.tensor(x, dtype=F32)


def _quad_row_sums(e):
    """Row sums as the kernel takes them: thread q of a quad adds its keys
    8j + 2q, 8j + 2q + 1 for j = 0..15 in order, then the quad's four
    partial sums by two xor shuffles: (s0 + s1) + (s2 + s3)."""
    part = []
    for q in range(4):
        s = torch.zeros(e.shape[:-1], dtype=F32)
        for j in range(16):
            for c in (0, 1):
                s = s + e[..., 8 * j + 2 * q + c]
        part.append(s)
    return (part[0] + part[1]) + (part[2] + part[3])


def _ex2(x, sign):
    """ex2.approx.ftz: 2^x, off by up to 2 ulp; the emulation moves each
    value by 2 ulp, up or down by a fixed pattern."""
    y = torch.exp2(x.double()).float()
    return y * (1 + sign * 2.0 ** -22)


def attend_emulated(iq, kmat, mode, pairs, keys, steps):
    win, idx = probes._windows(kmat, pairs, keys, steps)
    scale2, clip2 = _f32(0.125 * LOG2E), _f32(50.0 * LOG2E)
    out = torch.zeros(iq.shape, dtype=F32)
    sign = torch.where(torch.arange(keys) % 3 == 0, -1.0, 1.0)
    if mode == "int8":
        q8, s_q = quant(iq)
    for w in idx.tolist():
        k = win[w]
        if mode == "bf16":
            kb = k.bfloat16().float()
            s = iq.bfloat16().float() @ kb.T
            e = _ex2(torch.clamp(s * scale2, -clip2, clip2), sign)
            inv = _f32(1.0) / _quad_row_sums(e)
            p = (e * inv[:, None]).bfloat16().float()
            out += p @ kb
        else:
            k8, s_k = quant(k)
            s = q8 @ k8.T  # exact integers
            scale = ((s_q * s_k) * _f32(0.125)) * _f32(LOG2E)
            e = _ex2(torch.clamp(s * scale, -clip2, clip2), sign)
            inv = _f32(1.0) / _quad_row_sums(e)
            a8 = torch.round((e * inv[:, None]) * _f32(127.0))
            out += (a8 @ k8) * (s_k / _f32(127.0))
    return out


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("mag", [1.0, 4.0])
def test_attend_arithmetic_within_attend_bound(mode, mag):
    """At the probe's magnitudes (iq 1.5, kmat 1.2 standard deviations) and
    at 4 x them, where logits reach the ±50 clip."""
    gen = torch.Generator().manual_seed(7)
    pairs, keys, steps = 2, 128, 3
    iq = mag * 1.5 * torch.randn(128, 128, generator=gen)
    kmat = mag * 1.2 * torch.randn((2 * pairs - 1) * keys, 128, generator=gen)
    got = attend_emulated(iq, kmat, mode, pairs, keys, steps)
    ref = probe_attend_plain(iq, kmat, mode, pairs, keys, steps)
    bound = attend_bound(iq, kmat, mode, pairs, keys, steps)
    err = (got - ref).abs()
    assert bool((err <= bound).all()), (err - bound).max().item()
    if mag == 4.0 and mode == "bf16":
        lg = (iq.bfloat16().float() @ kmat.bfloat16().float().T) * 0.125
        assert lg.abs().max().item() > 50  # the clip is reached
    assert math.isfinite(got.abs().max().item())
