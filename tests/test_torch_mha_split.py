"""K4's forward kernel (``csrc/mha.cu::mha_fwd_kernel``) without a card: its
arithmetic emulated in torch on the CPU, held against the plain version
within K4's bound, and its launch plan (``ops/kernels/mha.py::fwd_plan``)
checked to cover every (query, valid key) pair exactly once.

The emulation does what the kernel does, step by step: the products as
3xTF32 (each operand split into hi = tf32(x), rounded by bit masking to
nearest with ties away from zero as ``cvt.rna.tf32.f32`` rounds, and lo =
x - hi, which the tensor cores read truncated to TF32; ``lo·hi + hi·lo +
hi·hi`` summed in f32), q times
scale·log2(e), the softmax a 64-key tile at a time in log2 units, only the
valid keys in key order, 8-key groups split over the block's warps, the
relabelled key order of P·V, and the merges of the warps' and the blocks'
partial (m, l, O).  The lane-level test checks that relabelling against the
mma.m16n8k8 fragment layouts.
"""
import os

import numpy as np
import pytest
import torch

from pcaudio_torch.checkpoint import load_reference_pth
from pcaudio_torch.data.synthetic import synth_clip
from pcaudio_torch.eval.experiments import _ranks_desc
from pcaudio_torch.nn import ST
from pcaudio_torch.nn import attention as st_attention
from pcaudio_torch.ops.kernels.mha import (
    FWD_KEY_TILE, FWD_WARP_ROWS, FWD_WARPS, FWD_WINDOW, FwdPlan, fused_mha_plain,
    fwd_plan)
from pcaudio_torch.train import RECIPES, prepare_framewise_data

DV, HEADS = 64, 8
SCALE = 1.0 / DV ** 0.5
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
SMS = 132                      # one H100's multiprocessors
FST_PTH = os.path.join(os.path.dirname(__file__), "..", "artifacts", "roundtrip",
                       "FST_roundtrip_net.pth")
# P·V's k-column c of an 8-key group is key PERM[c] of the group: column t
# holds key 2t, column t + 4 key 2t + 1 (t = lane % 4)
PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32: nearest, ties away from zero (the bit pattern
    plus half a TF32 ulp, the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 truncated to TF32 (the low 13 bits cleared), as the tensor cores
    read an operand."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def split(x):
    """hi = tf32(x) to nearest, lo = x - hi as the unit reads it."""
    hi = tf32(x)
    return hi, trunc_tf32(x - hi)


def mm(a, b, passes=3):
    """``a @ b`` as the kernel's tensor-core products: 3xTF32 (small terms
    first), or one TF32 pass."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def k4_bound_ok(got, ref):
    """K4's bound (chip_smoke.py, tests/test_torch_cuda.py): |err| <=
    1e-4·max|ref| + 1e-4·|ref|; returns (ok, max |err|, max |err| / bound)."""
    err = (got - ref).abs()
    bound = 1e-4 * ref.abs().max() + 1e-4 * ref.abs()
    return bool((err <= bound).all()), err.max().item(), (err / bound).max().item()


def _merge(states, exp2):
    """Partial (m, l, O) states → one, as the kernel merges them."""
    mx = torch.stack([s[0] for s in states]).amax(0)
    base = torch.where(mx == -torch.inf, torch.zeros_like(mx), mx)
    L, O = torch.zeros_like(mx), torch.zeros_like(states[0][2])
    for m, l, o in states:
        c = exp2(m - base)
        L = L + l * c
        O = O + o * c[..., None]
    return mx, L, O


def emulate_fwd(q, k, v, mask, num_heads, scale, passes=3):
    """The kernel's forward on CPU tensors: ``(out, lse)``."""
    B, N, dv = q.shape
    M = k.shape[1]
    dh = dv // num_heads
    plan = fwd_plan(B, N, M, num_heads, SMS, dh)
    pad = max(8, dh) - dh                    # dh 4 pads to 8 with zeros
    qs = torch.nn.functional.pad(
        (q * np.float32(scale * LOG2E)).reshape(B, N, num_heads, dh).transpose(1, 2),
        (0, pad))                            # [B, H, N, dh8]
    kh = torch.nn.functional.pad(k.reshape(B, M, num_heads, dh).transpose(1, 2), (0, pad))
    vh = v.reshape(B, M, num_heads, dh).transpose(1, 2)
    out = torch.empty(B, num_heads, N, dh)
    lse = torch.empty(B, num_heads, N)
    attend = _short if plan.parts == 0 else _tiled
    for b in range(B):
        m, L, O = attend(plan, qs[b], kh[b], vh[b], None if mask is None else mask[b],
                         passes)
        out[b] = torch.where(L[..., None] > 0, O / L.clamp_min(1e-30)[..., None], 0.0)
        lse[b] = torch.where(L > 0, (m + torch.log2(L.clamp_min(1e-30))) * LN2, torch.inf)
    return out.transpose(1, 2).reshape(B, N, dv), lse


def _tile(qs, kh, vh, idx, passes):
    """Scores [H, N, 64] of the keys ``idx`` (at most 64, zero-filled
    slots past them at -inf) and their V rows [H, 64, dh]."""
    H, nk = qs.shape[0], len(idx)
    kt = torch.zeros(H, FWD_KEY_TILE, kh.shape[-1])
    vt = torch.zeros(H, FWD_KEY_TILE, vh.shape[-1])
    kt[:, :nk], vt[:, :nk] = kh[:, idx], vh[:, idx]
    s = mm(qs, kt.transpose(1, 2), passes)
    s[..., nk:] = -torch.inf
    return s, vt


def _short(plan, qs, kh, vh, mask, passes):
    """The short-key kernel for one sample: all M <= 64 keys in key order in
    one tile, the masked ones at -inf (and their V rows zero)."""
    M = kh.shape[1]
    s, vt = _tile(qs, kh, vh, torch.arange(M), passes)
    if mask is not None:
        s[..., :M] = s[..., :M].masked_fill(~mask, -torch.inf)
        vt[:, :M] *= mask[:, None]
    m = s.amax(-1)
    pr = torch.exp2(s - torch.where(m == -torch.inf, 0.0, m)[..., None])
    order = torch.arange(FWD_KEY_TILE).view(8, 8)[:, PERM].reshape(-1)
    return m, pr.sum(-1), mm(pr[..., order], vt[:, order], passes)


def _tiled(plan, qs, kh, vh, mask, passes):
    """The tiled kernel for one sample: each key split's valid keys in key
    order, a 64-key tile at a time, each tile's 8-key groups split over the
    warps' parts; the parts' and then the splits' (m, l, O) merged."""
    H, N, dh = qs.shape[0], qs.shape[1], vh.shape[-1]
    M = kh.shape[1]
    G = 8 // plan.parts
    split_states = []
    for sp in range(plan.splits):
        kb, ke = M * sp // plan.splits, M * (sp + 1) // plan.splits
        st = [(torch.full((H, N), -torch.inf), torch.zeros(H, N), torch.zeros(H, N, dh))
              for _ in range(plan.parts)]
        for w0 in range(kb, ke, FWD_WINDOW):
            keys = torch.arange(w0, min(ke, w0 + FWD_WINDOW))
            if mask is not None:
                keys = keys[mask[keys]]
            for t0 in range(0, len(keys), FWD_KEY_TILE):
                s, vt = _tile(qs, kh, vh, keys[t0: t0 + FWD_KEY_TILE], passes)
                for p in range(plan.parts):
                    m, l, o = st[p]
                    cols = torch.arange(p * G * 8, (p + 1) * G * 8)
                    mn = torch.maximum(m, s[..., cols].amax(-1))
                    base = torch.where(mn == -torch.inf, torch.zeros_like(mn), mn)
                    alpha = torch.exp2(m - base)
                    pr = torch.exp2(s[..., cols] - base[..., None])
                    # P·V in the relabelled key order of each group
                    order = cols.view(G, 8)[:, PERM].reshape(-1)
                    o = o * alpha[..., None] + mm(pr[..., order - cols[0]], vt[:, order],
                                                  passes)
                    st[p] = (mn, l * alpha + pr.sum(-1), o)
        split_states.append(_merge(st, torch.exp2))
    return _merge(split_states, torch.exp2)


def lse_plain(q, k, mask, num_heads, scale):
    B, N, dv = q.shape
    logits = torch.einsum("bnhd,bmhd->bhnm", q.reshape(B, N, num_heads, -1),
                          k.reshape(B, k.shape[1], num_heads, -1)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], -torch.inf)
    lse = torch.logsumexp(logits, -1)
    return lse.masked_fill(lse == -torch.inf, torch.inf)   # no valid key: +inf


def _inputs(B, N, M, seed, mag=1.0, keep=None):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy((mag * rng.standard_normal((B, r, DV))).astype(np.float32))
               for r in (N, M, M))
    mask = None
    if keep is not None:      # expt 2's rank masks: the `keep` top-ranked keys
        mask = _ranks_desc(torch.from_numpy(rng.random((B, M)).astype(np.float32))) < keep
    return q, k, v, mask


def _check(q, k, v, mask, num_heads=HEADS, scale=SCALE):
    out, lse = emulate_fwd(q, k, v, mask, num_heads, scale)
    ok, err, ratio = k4_bound_ok(out, fused_mha_plain(q, k, v, mask, num_heads, scale))
    assert ok, f"out: max |err| {err:.3e}, {ratio:.2f} x the bound"
    ref = lse_plain(q, k, mask, num_heads, scale)
    assert torch.equal(torch.isinf(lse), torch.isinf(ref))
    fin = torch.isfinite(ref)
    lerr = (lse - ref)[fin].abs()
    # the backward reads exp(s - lse): an lse error e is a relative error e
    # in every gradient term, so hold it to a tenth of K4's 1e-4
    assert bool((lerr <= 1e-5 * (1 + ref[fin].abs())).all()), lerr.max().item()
    return ratio


# ---- the relabelled key order against the fragment layouts --------------------

def _a_regs(A):
    """mma.m16n8k8 .tf32 A fragment of a 16 x 8 matrix: regs[lane][r]."""
    return [[A[l // 4 + 8 * (r & 1), l % 4 + 4 * (r >> 1)] for r in range(4)]
            for l in range(32)]


def _b_regs(Bm):
    """B fragment of an 8 x 8 (k x n) matrix: regs[lane][r] = (k t + 4r, n g)."""
    return [[Bm[l % 4 + 4 * r, l // 4] for r in range(2)] for l in range(32)]


def _mma(a, b):
    """The product the unit forms from fragments: C[lane][r] at (row g + 8
    (r >= 2), column 2t + (r & 1))."""
    A = torch.zeros(16, 8)
    Bm = torch.zeros(8, 8)
    for l in range(32):
        g, t = l // 4, l % 4
        for r in range(4):
            A[g + 8 * (r & 1), t + 4 * (r >> 1)] = a[l][r]
        for r in range(2):
            Bm[t + 4 * r, g] = b[l][r]
    C = A @ Bm
    return [[C[l // 4 + 8 * (r >> 1), 2 * (l % 4) + (r & 1)] for r in range(4)]
            for l in range(32)]


def test_fragments_relabel_keys_without_a_shuffle():
    """S = Q·Kᵀ leaves keys 2t, 2t + 1 of rows g, g + 8 in a lane; the
    kernel hands those registers to P·V's A fragment as k-columns t, t + 4
    (regs 0, 2, 1, 3) and reads V's B fragment from key rows 2t, 2t + 1,
    so P·V is the plain product with no value moved between lanes."""
    gen = torch.Generator().manual_seed(0)
    Q, K, V = (torch.randn(r, 8, generator=gen) for r in (16, 8, 8))
    s = _mma(_a_regs(Q), [[K[l // 4, l % 4], K[l // 4, l % 4 + 4]] for l in range(32)])
    S = Q @ K.T
    for l in range(32):
        g, t = l // 4, l % 4
        want = S[[g, g, g + 8, g + 8], [2 * t, 2 * t + 1, 2 * t, 2 * t + 1]]
        torch.testing.assert_close(torch.stack(s[l]), want)
    a = [[s[l][0], s[l][2], s[l][1], s[l][3]] for l in range(32)]
    b = [[V[2 * (l % 4), l // 4], V[2 * (l % 4) + 1, l // 4]] for l in range(32)]
    o = _mma(a, b)
    O = S @ V
    for l in range(32):
        g, t = l // 4, l % 4
        want = O[[g, g, g + 8, g + 8], [2 * t, 2 * t + 1, 2 * t, 2 * t + 1]]
        torch.testing.assert_close(torch.stack(o[l]), want)
    # the same relabelling as the emulation's PERM
    assert [2 * (c % 4) + c // 4 for c in range(8)] == PERM.tolist()


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 3.14159265, 0.0, -0.0, 2.0 ** -130])
    got = tf32(x)
    assert got[:5].tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                                -(1.0 + 2 ** -10)]      # ties away from zero
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert (((got - x) / x)[:6].abs() <= 2 ** -11).all()
    hi, lo = split(x[5:6])
    assert abs((hi + lo - x[5:6]).item()) <= 2 ** -21 * 3.2
    assert trunc_tf32(torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11)])).tolist() == [1.0, -1.0]


# ---- the emulated kernel against the plain version -------------------------

FST = {"MAB0": (64, 1025), "MAB1": (1025, 64), "PMA": (1, 1025)}
ST3 = {"MAB0": (64, 5120), "MAB1": (5120, 64), "PMA": (1, 5120)}


@pytest.mark.parametrize("recipe,attend", [(r, a) for r in ("FST", "3ST")
                                           for a in ("MAB0", "MAB1", "PMA")])
def test_emulation_within_k4_bound_at_the_recipes_attends(recipe, attend):
    N, M = (FST if recipe == "FST" else ST3)[attend]
    B = 2 if recipe == "FST" else 1
    _check(*_inputs(B, N, M, seed=N + M))


@pytest.mark.parametrize("keep", [1, 501, 1025])
@pytest.mark.parametrize("attend", ["MAB0", "PMA"])
def test_emulation_within_k4_bound_on_rank_masks(attend, keep):
    """expt 2's masks: only the ``keep`` top-ranked of 1025 keys, scattered
    over the frame, so valid keys straddle every tile edge."""
    N, M = FST[attend]
    _check(*_inputs(3, N, M, seed=keep, keep=keep))


@pytest.mark.parametrize("N,M", [(64, 1025), (1, 1025), (17, 300), (1025, 64),
                                 (64, 5120)])
def test_emulation_within_k4_bound_at_randn_times_8(N, M):
    """Logits 64 times randn's (|s| up to about 80): the split's error grows
    with sum |q_d k_d|, the bound with |out| alone (at B = 2 and 5120 keys
    the plan splits the keys over 10 blocks)."""
    _check(*_inputs(2, N, M, seed=3, mag=8.0))


def test_emulation_splits_and_parts_with_ragged_masks():
    """Key splits (3 at B = 4, 20 queries, 1100 keys) over prefix masks: a
    split or a warp's part may hold no valid key, and a sample none at all
    (zeros, lse +inf)."""
    q, k, v, _ = _inputs(4, 20, 1100, seed=5)
    assert fwd_plan(4, 20, 1100, HEADS, SMS) == FwdPlan(2, 32, 1, 3)
    counts = torch.tensor([1100, 0, 3, 567])
    mask = torch.arange(1100)[None, :] < counts[:, None]
    _check(q, k, v, mask)
    out, lse = emulate_fwd(q, k, v, mask, HEADS, SCALE)
    assert not out[1].any() and torch.isinf(lse[1]).all()


def _fst_attends(mask_keep):
    """q, k, v and the mask of every attend of the trained FST on one
    synthetic frame (the port's FST featurizer), on the CPU."""
    cfg = RECIPES["FST"]()
    wave = synth_clip(3, 7, n=44100)
    data = prepare_framewise_data(wave[None], np.array([len(wave)], np.int32),
                                  np.array([3]), cfg, device="cpu")
    pts = torch.from_numpy(data["points"][len(data["points"]) // 2][None])
    model = ST(dim_input=2, dim_output=10, num_inds=64, dim_hidden=64, num_heads=8)
    model.load_state_dict(load_reference_pth(FST_PTH))
    mask = None
    if mask_keep is not None:
        mask = _ranks_desc(pts[..., 1]) < mask_keep
    calls = []
    plain = st_attention.fused_mha_plain

    def record(q, k, v, m, num_heads, scale):
        calls.append((q.detach().clone(), k.detach().clone(), v.detach().clone(), m,
                      num_heads, scale))
        return plain(q, k, v, m, num_heads, scale)
    st_attention.fused_mha_plain = record
    try:
        with torch.no_grad():
            model.eval()(pts, mask)
    finally:
        st_attention.fused_mha_plain = plain
    return calls


@pytest.mark.parametrize("keep", [None, 501])
def test_emulation_within_k4_bound_on_the_trained_fst(keep):
    """The trained FST's own q, k, v (roundtrip checkpoint), whose logits
    are larger than randn's, unmasked and at expt 2's rank mask K 501."""
    calls = _fst_attends(keep)
    assert len(calls) == 5      # two ISABs' MAB0 and MAB1, PMA
    for q, k, v, m, h, scale in calls:
        _check(q, k, v, m, h, scale)


def test_one_tf32_pass_misses_the_bound():
    """Without the lo parts (one TF32 pass, 2^-11 roundings of q, k, p and
    v) the same inputs fall outside K4's bound, so the split is needed."""
    q, k, v, mask = _inputs(2, 64, 1025, seed=11)
    ref = fused_mha_plain(q, k, v, mask, HEADS, SCALE)
    one, _ = emulate_fwd(q, k, v, mask, HEADS, SCALE, passes=1)
    three, _ = emulate_fwd(q, k, v, mask, HEADS, SCALE, passes=3)
    ok1, err1, ratio1 = k4_bound_ok(one, ref)
    ok3, err3, ratio3 = k4_bound_ok(three, ref)
    assert not ok1 and ratio1 > 2, (err1, ratio1)
    assert ok3 and ratio3 < 0.1, (err3, ratio3)


# ---- the launch plan covers each (row, valid key) pair once ------------------

def _schedule(plan, N, M, valid):
    """The kernel's loops for one (sample, head): per block (qt, sp) and warp
    w, its rows and its keys; returns coverage counts [N, M]."""
    cover = np.zeros((N, M), np.int64)
    if plan.parts == 0:   # short-key kernel: warp w takes 16-row tiles w, w + 4, ...
        keys = [j for gi in range(8) for c in range(8) if (j := gi * 8 + c) < M and valid[j]]
        for qt in range(plan.qtiles):
            end = min(N, (qt + 1) * plan.rows)
            for w in range(FWD_WARPS):
                for row0 in range(qt * plan.rows + w * FWD_WARP_ROWS, end,
                                  FWD_WARPS * FWD_WARP_ROWS):
                    rows = [r for r in range(row0, row0 + FWD_WARP_ROWS) if r < N]
                    if keys:
                        np.add.at(cover, np.ix_(rows, keys), 1)
        return cover
    wq_n = FWD_WARPS // plan.parts
    G = 8 // plan.parts
    for qt in range(plan.qtiles):
        for sp in range(plan.splits):
            kb, ke = M * sp // plan.splits, M * (sp + 1) // plan.splits
            for w in range(FWD_WARPS):
                wq, part = w % wq_n, w // wq_n
                row0 = (qt * wq_n + wq) * FWD_WARP_ROWS
                rows = [r for r in range(row0, row0 + FWD_WARP_ROWS) if r < N]
                keys = []
                for w0 in range(kb, ke, FWD_WINDOW):
                    lst = [j for j in range(w0, min(ke, w0 + FWD_WINDOW)) if valid[j]]
                    for t0 in range(0, len(lst), FWD_KEY_TILE):
                        for gi in range(G):
                            for c in range(8):
                                slot = t0 + (part * G + gi) * 8 + c
                                if slot < len(lst) and slot < t0 + FWD_KEY_TILE:
                                    keys.append(lst[slot])
                if rows and keys:
                    np.add.at(cover, np.ix_(rows, keys), 1)
    return cover


# (B, N, M): the recipes' attends, expt 2's batch, edges of the row tiles
# and the key tiles, key splits; windows of 8,192 keys (40 samples: no split)
SHAPES = ([(128, N, M) for N, M in FST.values()] + [(16, N, M) for N, M in ST3.values()]
          + [(1024, N, M) for N, M in FST.values()]
          + [(3, N, M) for N in (1, 15, 16, 17, 33, 1025) for M in (1, 7, 65)]
          + [(4, 20, 1100), (40, 1, 17000), (40, 70, 9000), (2, 20, 17000)])


@pytest.mark.parametrize("B,N,M", SHAPES, ids=str)
@pytest.mark.parametrize("pattern", ["full", "rank", "ragged"])
def test_plan_covers_each_pair_exactly_once(B, N, M, pattern):
    plan = fwd_plan(B, N, M, HEADS, SMS)
    assert plan.parts == 0 or plan.parts * plan.rows == FWD_WARPS * FWD_WARP_ROWS
    assert (plan.qtiles - 1) * plan.rows < N <= plan.qtiles * plan.rows
    rng = np.random.default_rng(N * M)
    valid = {"full": np.ones(M, bool),
             "rank": rng.random(M) < 0.5,
             "ragged": np.arange(M) < M // 3}[pattern]
    rows = np.arange(N) if N <= 1100 else np.r_[0:40, N - 40:N]
    cover = _schedule(plan, N, M, valid)[rows]
    assert (cover == valid[None, :].astype(np.int64)).all()


def test_plan_splits_keys_only_where_blocks_are_few():
    # 3ST training at B = 16: MAB0 and PMA make 128 blocks on 132 SMs
    assert fwd_plan(16, 64, 5120, HEADS, SMS).splits == 5
    assert fwd_plan(16, 1, 5120, HEADS, SMS) == FwdPlan(4, 16, 1, 5)
    assert fwd_plan(40, 1, 17000, HEADS, SMS).splits == 1   # 3 windows of keys
    for N, M in FST.values():          # FST training and expt 2 fill the card
        assert fwd_plan(128, N, M, HEADS, SMS).splits == 1
        assert fwd_plan(1024, N, M, HEADS, SMS).splits == 1
    assert fwd_plan(2, 64, 300, HEADS, SMS).splits == 1     # too few keys to split
    assert [fwd_plan(1, N, 65, 1, SMS).parts for N in (1, 16, 17, 32, 33)] == [4, 4, 2, 2, 1]


def test_plan_takes_the_short_kernel_for_64_keys():
    """MAB1 (64 keys): one block a (sample, head) at expt 2's batch, enough
    blocks for about 8 an SM where the batch is small, rows a multiple of 64."""
    assert fwd_plan(1024, 1025, 64, HEADS, SMS) == FwdPlan(0, 1088, 1, 1)
    assert fwd_plan(128, 1025, 64, HEADS, SMS) == FwdPlan(0, 576, 2, 1)
    assert fwd_plan(16, 5120, 64, HEADS, SMS) == FwdPlan(0, 576, 9, 1)
    assert fwd_plan(2, 300, 9, HEADS, SMS).parts == 0
    assert fwd_plan(2, 300, 64, HEADS, SMS, dh=16).parts == 1   # dh 16: tiled
    assert fwd_plan(2, 300, 65, HEADS, SMS).parts == 1


# ---- the stage probe's source edits ---------------------------------------

def test_stage_probe_edits_cut_the_forward_where_they_say():
    """``probes/k4_stages.py`` builds copies of ``csrc/mha.cu`` with its stop
    constant edited: each edit applies, and each cut is a distinct source."""
    from pcaudio_torch.ops.kernels import _build
    from pcaudio_torch.probes import k2_stages, k4_stages

    source = (_build.CSRC / "mha.cu").read_text()
    srcs = k2_stages.stage_sources(source, k4_stages.CURRENT_EDITS, "mha.cu")
    assert set(srcs) == set(k4_stages.STAGES) and srcs["whole"] == source
    for n, stage in enumerate(k4_stages.STAGES[:-1], 1):
        assert f"constexpr int kStopAfter = {n};" in srcs[stage]
    assert len(set(srcs.values())) == len(k4_stages.STAGES)
    with pytest.raises(ValueError, match="kStopAfter = 0"):
        k2_stages.stage_sources(source.replace("kStopAfter = 0", "kStopAfter = 9"),
                                k4_stages.CURRENT_EDITS, "edited mha.cu")


def test_fwd_kernels_names_every_forward_kernel():
    """``chip_smoke.py`` finds K4's forward and backward in a profile by
    these names: every ``__global__`` kernel of ``csrc/mha.cu`` is among
    them, the forward's in ``FWD_KERNELS`` and the backward's in
    ``BWD_KERNELS``, and each name is one (a renamed kernel would otherwise
    read as a share of 0)."""
    import re

    from pcaudio_torch.ops.kernels import _build
    from pcaudio_torch.ops.kernels.mha import BWD_KERNELS, BWD_PAIR_KERNELS, FWD_KERNELS

    source = (_build.CSRC / "mha.cu").read_text()
    kernels = set(re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(", source))
    assert {k for k in kernels if k.startswith("mha_fwd")} == set(FWD_KERNELS)
    assert kernels - set(FWD_KERNELS) == set(BWD_KERNELS)
    assert set(BWD_PAIR_KERNELS) == {"mha_dq_kernel", "mha_dkdv_kernel"} <= set(BWD_KERNELS)
