"""K4's backward (``csrc/mha.cu``: ``mha_bwd_fewq_kernel``,
``mha_bwd_fewk_kernel``, ``mha_bwd_merge_kernel``) without a card: its
arithmetic emulated in torch on the CPU, held against the plain backward
within K4's bound, and its launch plan (``ops/kernels/mha.py::bwd_plan``)
checked to cover every (query, valid key) pair exactly once.

The emulation does what the kernels do, step by step, on the forward
emulation's ``out`` and ``lse`` (``tests/test_torch_mha_split.py``): keys
are the products' 16 rows and queries their 8 columns; S^T = K·Q^T and
dP^T = V·G^T as 3xTF32 products, P^T = 2^(S^T·c − lse·log2 e) with c =
scale·log2 e, dS^T = P^T ⊙ (dP^T − D) with D = rowsum(G ⊙ out); dV and dK
over 8-query steps, dQ over 8-key groups of the transposed dS; the small
side held, the large side in 16-row tiles taken by warp w as tiles w, w +
4, …; the warps' partial sums added in warp order and the splits' in split
order.  The lane-level test checks the fragment relabelling and the
in-register transpose against the mma.m16n8k8 and movmatrix layouts.
"""
import numpy as np
import pytest
import torch

from pcaudio_torch.ops.kernels.mha import (
    BWD_HELD, BWD_TILE, BWD_WARPS, BwdPlan, bwd_plan, fused_mha_bwd_plain)
from test_torch_mha_split import (
    FST, HEADS, LOG2E, SCALE, SMS, ST3, _a_regs, _b_regs, _fst_attends, _inputs, _mma,
    emulate_fwd, k4_bound_ok, mm)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the emulation's many small products run faster so,
    and xdist's workers do not oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _seq_sum(parts, start=None):
    """Sum in the given order, from 0 (the kernels' fixed orders)."""
    acc = torch.zeros_like(parts[0]) if start is None else start
    for p in parts:
        acc = acc + p
    return acc


def _pair_terms(kt, vt, rows_ok, qs, gs, l2, D, c, passes):
    """One pass over a batch of key tiles against the query columns: P^T,
    dS^T [..., rows, queries] as the kernels form them."""
    s = mm(kt, qs.transpose(-1, -2), passes)
    dp = mm(vt, gs.transpose(-1, -2), passes)
    # fmaf(s, c, -l2): the product exact in double, one rounding
    p = torch.exp2((s.double() * float(c) - l2[..., None, :].double()).float())
    p = torch.where(rows_ok[..., :, None], p, torch.zeros_like(p))
    return p, p * (dp - D[..., None, :])


def _steps(a, b, width, passes):
    """a [..., R, W] @ b [..., W, d] as the kernels' mma k-steps of ``width``
    columns, accumulated in order: ``[step contributions]``."""
    return [mm(a[..., i:i + width], b[..., i:i + width, :], passes)
            for i in range(0, a.shape[-1], width)]


def _pad_rows(x, rows):
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[-2]))


def emulate_bwd(q, k, v, mask, out, lse, g, num_heads, scale, passes=3, plan=None):
    """The kernels' backward on CPU tensors: ``(dq, dk, dv)``."""
    B, N, dv = q.shape
    M = k.shape[1]
    dh = dv // num_heads
    plan = plan or bwd_plan(B, N, M, num_heads, SMS, dh)
    assert plan.kind in ("fewq", "fewk"), plan
    heads = [x.reshape(B, -1, num_heads, dh).transpose(1, 2) for x in (q, k, v, out, g)]
    qh, kh, vh, oh, gh = heads                                    # [B, H, rows, dh]
    D = (gh * oh).sum(-1)                                         # [B, H, N]
    l2 = lse * np.float32(LOG2E)
    c = np.float32(scale * LOG2E)
    dq, dk, dvv = (torch.zeros(B, num_heads, r, dh) for r in (N, M, M))
    T = BWD_TILE
    for b in range(B):
        valid = torch.ones(M, dtype=torch.bool) if mask is None else mask[b]
        if plan.kind == "fewq":
            part_dq = []
            for sp in range(plan.splits):
                kb, ke = M * sp // plan.splits, M * (sp + 1) // plan.splits
                keys = torch.arange(kb, ke)[valid[kb:ke]]         # compacted, key order
                n = len(keys)
                ntiles = -(-n // T)
                kt = _pad_rows(kh[b][:, keys], ntiles * T).reshape(num_heads, ntiles, T, dh)
                vt = _pad_rows(vh[b][:, keys], ntiles * T).reshape(num_heads, ntiles, T, dh)
                ok = (torch.arange(ntiles * T) < n).reshape(ntiles, T)
                npad = -(-N // T) * T
                qs, gs = (_pad_rows(x[b], npad)[:, None] for x in (qh, gh))
                l2p = torch.full((num_heads, npad), torch.inf)
                l2p[:, :N] = l2[b]
                Dp = torch.zeros(num_heads, npad)
                Dp[:, :N] = D[b]
                p, ds = _pair_terms(kt, vt, ok, qs, gs, l2p[:, None], Dp[:, None], c, passes)
                # dK, dV: complete a tile, over the 8-query steps in order
                dvt = _seq_sum(_steps(p, gs, 8, passes))
                dkt = _seq_sum(_steps(ds, qs, 8, passes))
                dk[b][:, keys] = dkt.reshape(num_heads, -1, dh)[:, :n] * np.float32(scale)
                dvv[b][:, keys] = dvt.reshape(num_heads, -1, dh)[:, :n]
                # dQ: per warp over its tiles (8-key groups in order), then warps
                contrib = _steps(ds.transpose(-1, -2), kt, 8, passes)   # [H, tiles, npad, dh] x2
                warps = []
                for w in range(BWD_WARPS):
                    acc = torch.zeros(num_heads, npad, dh)
                    for t in range(w, ntiles, BWD_WARPS):
                        acc = (acc + contrib[0][:, t]) + contrib[1][:, t]
                    warps.append(acc)
                part_dq.append(_seq_sum(warps)[:, :N])
            dq[b] = _seq_sum(part_dq) * np.float32(scale)
        else:
            mpad = -(-M // T) * T
            ok = torch.zeros(mpad, dtype=torch.bool)
            ok[:M] = valid
            kt, vt = (_pad_rows(x[b] * valid[:, None], mpad).reshape(num_heads, -1, T, dh)
                      for x in (kh, vh))
            part_dk, part_dv = [], []
            for sp in range(plan.splits):
                qb, qe = N * sp // plan.splits, N * (sp + 1) // plan.splits
                ntiles = -(-(qe - qb) // T)
                rows = torch.arange(qb, qb + ntiles * T)
                inr = rows < qe
                rows = rows.clamp(max=N - 1)
                qs, gs = ((x[b][:, rows] * inr[:, None]).reshape(num_heads, ntiles, 1, T, dh)
                          for x in (qh, gh))
                l2t = torch.where(inr, l2[b][:, rows], torch.inf).reshape(num_heads, ntiles, 1, T)
                Dt = (D[b][:, rows] * inr).reshape(num_heads, ntiles, 1, T)
                # [H, query tile, key tile, 16 keys, 16 queries]
                p, ds = _pair_terms(kt[:, None], vt[:, None], ok.reshape(-1, T), qs, gs,
                                    l2t, Dt, c, passes)
                dvc = _seq_sum(_steps(p, gs, 8, passes))          # [H, qtiles, ktiles, 16, dh]
                dkc = _seq_sum(_steps(ds, qs, 8, passes))
                wdk, wdv = [], []
                for w in range(BWD_WARPS):
                    mine = list(range(w, ntiles, BWD_WARPS))
                    wdk.append(_seq_sum([dkc[:, i] for i in mine], torch.zeros_like(dkc[:, 0])))
                    wdv.append(_seq_sum([dvc[:, i] for i in mine], torch.zeros_like(dvc[:, 0])))
                part_dk.append(_seq_sum(wdk).reshape(num_heads, mpad, dh)[:, :M])
                part_dv.append(_seq_sum(wdv).reshape(num_heads, mpad, dh)[:, :M])
                # dQ: complete a query tile, over the key tiles and groups in order
                contrib = _steps(ds.transpose(-1, -2), kt[:, None], 8, passes)
                acc = torch.zeros(num_heads, ntiles, T, dh)
                for j in range(kt.shape[1]):
                    acc = (acc + contrib[0][:, :, j]) + contrib[1][:, :, j]
                dq[b][:, qb:qe] = acc.reshape(num_heads, -1, dh)[:, :qe - qb] * np.float32(scale)
            dk[b] = _seq_sum(part_dk) * np.float32(scale)
            dvv[b] = _seq_sum(part_dv)
    return tuple(x.transpose(1, 2).reshape(B, -1, dv) for x in (dq, dk, dvv))


def _grads_check(q, k, v, mask, g, num_heads=HEADS, scale=SCALE, joint=False, passes=3):
    """The emulated backward (on the emulated forward's out and lse) against
    the plain backward; returns the largest |err| / bound of dq, dk, dv,
    each against its own scale, or of the three as one vector (``joint``:
    where dq and dk vanish in exact arithmetic, their rounding noise is held
    against the common scale, as the card tests do)."""
    out, lse = emulate_fwd(q, k, v, mask, num_heads, scale)
    got = emulate_bwd(q, k, v, mask, out, lse, g, num_heads, scale, passes)
    ref = fused_mha_bwd_plain(q, k, v, mask, g, num_heads, scale)
    if joint:
        return [k4_bound_ok(torch.cat([x.flatten() for x in got]),
                            torch.cat([x.flatten() for x in ref]))]
    return [k4_bound_ok(a, r) for a, r in zip(got, ref)]


def _assert_within(results, what=""):
    for (ok, err, ratio), name in zip(results, ("dq", "dk", "dv")):
        assert ok, f"{what}{name}: max |err| {err:.3e}, {ratio:.2f} x the bound"


def _with_g(B, N, M, seed, mag=1.0, keep=None):
    q, k, v, mask = _inputs(B, N, M, seed, mag, keep)
    g = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((B, N, q.shape[-1]))
                         .astype(np.float32))
    return q, k, v, mask, g


# ---- the emulated kernels against the plain backward ------------------------

@pytest.mark.parametrize("recipe,attend", [(r, a) for r in ("FST", "3ST")
                                           for a in ("MAB0", "MAB1", "PMA")])
def test_emulation_within_k4_bound_at_the_recipes_attends(recipe, attend):
    """FST at B = 2 (no split), 3ST at B = 1 (the large side split over 10
    blocks, as the plan splits it where blocks are few)."""
    N, M = (FST if recipe == "FST" else ST3)[attend]
    B = 2 if recipe == "FST" else 1
    _assert_within(_grads_check(*_with_g(B, N, M, seed=N + M)))


@pytest.mark.parametrize("N,M", [(64, 1025), (1, 1025), (1025, 64), (17, 300), (300, 9)])
def test_emulation_within_k4_bound_at_randn_times_8(N, M):
    """Logits 64 times randn's: the split's error grows with sum |q_d k_d|
    and |p (dP − D)|, the bound with the gradients alone."""
    _assert_within(_grads_check(*_with_g(2, N, M, seed=3, mag=8.0)))


@pytest.mark.parametrize("N,M,plan", [
    (64, 300, None), (1, 37, None), (300, 9, None), (300, 64, None),
    (64, 1100, BwdPlan("fewq", 3)), (1100, 64, BwdPlan("fewk", 3))], ids=str)
def test_emulation_within_k4_bound_with_ragged_masks(N, M, plan):
    """Prefix masks with a full sample, one with a single valid key (dq and
    dk vanish there) and one with none (zero gradients), also where the
    splits hold no valid key."""
    q, k, v, _, g = _with_g(4, N, M, seed=5)
    counts = torch.tensor([M, 1, 0, max(1, M // 3)])
    mask = torch.arange(M)[None, :] < counts[:, None]
    out, lse = emulate_fwd(q, k, v, mask, HEADS, SCALE)
    got = emulate_bwd(q, k, v, mask, out, lse, g, HEADS, SCALE, plan=plan)
    ref = fused_mha_bwd_plain(q, k, v, mask, g, HEADS, SCALE)
    _assert_within([k4_bound_ok(a, r) for a, r in zip(got, ref)])
    assert not any(x[2].any() for x in got)


@pytest.mark.parametrize("keep", [1, 501])
def test_emulation_within_k4_bound_on_rank_masks(keep):
    """expt 2's rank masks at FST's MAB0: valid keys scattered over the
    frame, straddling every 16-key tile; at K 1 dq and dk vanish."""
    q, k, v, mask, g = _with_g(2, 64, 1025, seed=keep, keep=keep)
    _assert_within(_grads_check(q, k, v, mask, g, joint=keep == 1))


def _coincide(k, v, mask):
    """All keys and values of every sample equal (the trained FST's MAB1,
    whose 64 inducing summaries coincide), or at most one valid key a row:
    dq and dk vanish in exact arithmetic."""
    if mask is not None and int(mask.sum(1).max()) <= 1:
        return True
    return bool((k == k[:, :1]).all() and (v == v[:, :1]).all())


def test_emulation_within_k4_bound_on_the_trained_fst():
    """The trained FST's own q, k, v (roundtrip checkpoint) at its five
    attends, with a seeded g."""
    calls = _fst_attends(None)
    assert len(calls) == 5
    for i, (q, k, v, m, h, scale) in enumerate(calls):
        g = torch.from_numpy(np.random.default_rng(i).standard_normal(q.shape)
                             .astype(np.float32))
        _assert_within(_grads_check(q, k, v, m, g, h, scale, joint=_coincide(k, v, m)),
                       f"attend {i}: ")


def test_one_tf32_pass_misses_the_bound():
    """Without the lo parts (one TF32 pass) the same inputs fall outside
    K4's bound, so the 3xTF32 split is needed in the backward too."""
    q, k, v, mask, g = _with_g(2, 64, 1025, seed=11)
    one = _grads_check(q, k, v, mask, g, passes=1)
    three = _grads_check(q, k, v, mask, g, passes=3)
    assert not all(ok for ok, _, _ in one) and max(r for _, _, r in one) > 2, one
    assert all(ok for ok, _, _ in three) and max(r for _, _, r in three) < 0.1, three


# ---- the fragment layouts ------------------------------------------------------

def _movmatrix(words):
    """PTX movmatrix.m8n8.trans.b16: lane l holds row l // 4, columns 2 (l %
    4), 2 (l % 4) + 1 of an 8x8 matrix of 16-bit words (low half first);
    afterwards the same of its transpose."""
    m = np.zeros((8, 8), np.uint32)
    for lane, w in enumerate(words):
        m[lane // 4, 2 * (lane % 4)] = w & 0xFFFF
        m[lane // 4, 2 * (lane % 4) + 1] = w >> 16
    t = m.T
    return [int(t[l // 4, 2 * (l % 4)]) | int(t[l // 4, 2 * (l % 4) + 1]) << 16
            for l in range(32)]


def _byte_perm(x, y, s):
    b = list(int(x).to_bytes(4, "little")) + list(int(y).to_bytes(4, "little"))
    return int.from_bytes(bytes(b[(s >> (4 * i)) & 7] for i in range(4)), "little")


def _transpose8x8(x0, x1):
    """csrc/mma.cuh::transpose8x8 on the 32 lanes' (x0, x1) float pairs."""
    a = [int(np.float32(v).view(np.uint32)) for v in x0]
    b = [int(np.float32(v).view(np.uint32)) for v in x1]
    lo = _movmatrix([_byte_perm(p, r, 0x5410) for p, r in zip(a, b)])
    hi = _movmatrix([_byte_perm(p, r, 0x7632) for p, r in zip(a, b)])
    f = lambda w: float(np.uint32(w).view(np.float32))  # noqa: E731
    return ([f(_byte_perm(p, r, 0x5410)) for p, r in zip(lo, hi)],
            [f(_byte_perm(p, r, 0x7632)) for p, r in zip(lo, hi)])


def test_fragments_of_the_backward_products():
    """One pair tile through the mma.m16n8k8 layouts lane by lane: S^T = K
    Q^T's C fragment, relabelled as an A fragment (regs 0, 2, 1, 3; B rows
    2t, 2t + 1), gives dV = P^T G with no value moved between lanes; dS^T's
    8x8 blocks transposed in registers (movmatrix on the low and high
    halves) give dQ = dS K's A fragment."""
    gen = torch.Generator().manual_seed(1)
    K, Q, G = (torch.randn(r, 8, generator=gen) for r in (16, 16, 16))
    # S^T [16 keys, 16 queries] as two 8-column n-tiles
    c = [_mma(_a_regs(K), _b_regs(Q[8 * nt:8 * nt + 8].T)) for nt in range(2)]
    ST = K @ Q.T
    for nt in range(2):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            want = ST[[g, g, g + 8, g + 8], [8 * nt + 2 * t, 8 * nt + 2 * t + 1] * 2]
            torch.testing.assert_close(torch.stack(c[nt][lane]), want)
    # dV += P^T G over each n-tile's 8 queries, A from C regs (0, 2, 1, 3)
    dv = torch.zeros(16, 8)
    for nt in range(2):
        a = [[c[nt][l][0], c[nt][l][2], c[nt][l][1], c[nt][l][3]] for l in range(32)]
        b = [[G[8 * nt + 2 * (l % 4), l // 4], G[8 * nt + 2 * (l % 4) + 1, l // 4]]
             for l in range(32)]
        o = _mma(a, b)
        for l in range(32):
            g, t = l // 4, l % 4
            for r in range(4):
                dv[g + 8 * (r >> 1), 2 * t + (r & 1)] += o[l][r]
    torch.testing.assert_close(dv, ST @ G)
    # dQ = (S^T)^T K: block (key group kg, n-tile nt) transposed, A rows g
    # (nt 0) and g + 8 (nt 1), k-columns t, t + 4 = keys 8 kg + 2t, + 1
    dq = torch.zeros(16, 8)
    for kg in range(2):
        tr = [_transpose8x8([c[nt][l][2 * kg] for l in range(32)],
                            [c[nt][l][2 * kg + 1] for l in range(32)]) for nt in range(2)]
        a = [[tr[0][0][l], tr[1][0][l], tr[0][1][l], tr[1][1][l]] for l in range(32)]
        b = [[K[8 * kg + 2 * (l % 4), l // 4], K[8 * kg + 2 * (l % 4) + 1, l // 4]]
             for l in range(32)]
        o = _mma(a, b)
        for l in range(32):
            g, t = l // 4, l % 4
            for r in range(4):
                dq[g + 8 * (r >> 1), 2 * t + (r & 1)] += o[l][r]
    torch.testing.assert_close(dq, ST.T @ K)


def test_transpose8x8_moves_every_bit():
    """The two halves' transposes reassemble each f32 word exactly (signs,
    infinities and subnormals included)."""
    rng = np.random.default_rng(0)
    m = rng.standard_normal((8, 8)).astype(np.float32)
    m[0, 1], m[3, 5], m[7, 2] = -np.inf, np.float32(1e-42), -0.0
    x0 = [m[l // 4, 2 * (l % 4)] for l in range(32)]
    x1 = [m[l // 4, 2 * (l % 4) + 1] for l in range(32)]
    y0, y1 = _transpose8x8(x0, x1)
    got = np.zeros((8, 8), np.float32)
    for l in range(32):
        got[l // 4, 2 * (l % 4)], got[l // 4, 2 * (l % 4) + 1] = y0[l], y1[l]
    assert got.view(np.uint32).tolist() == m.T.view(np.uint32).tolist()


# ---- the plan covers each (query, valid key) pair once -----------------------

def _bwd_schedule(plan, N, M, valid):
    """The kernels' loops for one (sample, head): coverage counts [N, M] of
    the pairs that reach a P (valid rows of a tile against valid columns)."""
    cover = np.zeros((N, M), np.int64)
    if plan.kind == "fewq":
        for sp in range(plan.splits):
            kb, ke = M * sp // plan.splits, M * (sp + 1) // plan.splits
            lst = [j for j in range(kb, ke) if valid[j]]
            ntiles = -(-len(lst) // BWD_TILE)
            for w in range(BWD_WARPS):
                for t in range(w, ntiles, BWD_WARPS):
                    keys = lst[t * BWD_TILE:(t + 1) * BWD_TILE]
                    for qt in range(-(-N // BWD_TILE)):
                        rows = [r for r in range(qt * BWD_TILE, (qt + 1) * BWD_TILE) if r < N]
                        np.add.at(cover, np.ix_(rows, keys), 1)
    else:
        keys = [j for j in range(M) if valid[j]]
        for sp in range(plan.splits):
            qb, qe = N * sp // plan.splits, N * (sp + 1) // plan.splits
            for w in range(BWD_WARPS):
                for r0 in range(qb + w * BWD_TILE, qe, BWD_WARPS * BWD_TILE):
                    rows = [r for r in range(r0, r0 + BWD_TILE) if r < qe]
                    if keys:
                        np.add.at(cover, np.ix_(rows, keys), 1)
    return cover


SHAPES = ([(128, N, M) for N, M in FST.values()] + [(16, N, M) for N, M in ST3.values()]
          + [(3, N, M) for N in (1, 15, 16, 17, 64) for M in (1, 7, 65, 300)]
          + [(3, N, M) for N in (65, 300) for M in (1, 9, 64)]
          + [(2, 64, 1100), (2, 1100, 64), (1, 20, 17000)])


@pytest.mark.parametrize("B,N,M", SHAPES, ids=str)
@pytest.mark.parametrize("pattern", ["full", "rank", "ragged"])
def test_bwd_plan_covers_each_pair_exactly_once(B, N, M, pattern):
    plan = bwd_plan(B, N, M, HEADS, SMS)
    assert plan.kind != "pair" and plan.splits >= 1
    assert (plan.kind == "fewq") == (N <= BWD_HELD and (M > BWD_HELD or N <= M))
    rng = np.random.default_rng(N * M)
    valid = {"full": np.ones(M, bool),
             "rank": rng.random(M) < 0.5,
             "ragged": np.arange(M) < M // 3}[pattern]
    cover = _bwd_schedule(plan, N, M, valid)
    assert (cover == valid[None, :].astype(np.int64)).all()


def test_bwd_plan_splits_only_where_blocks_are_few():
    # 3ST training at B = 16: 128 blocks on 132 SMs, the large side split
    for N, M in ST3.values():
        plan = bwd_plan(16, N, M, HEADS, SMS)
        assert plan.splits == 5 and plan.kind == ("fewk" if M == 64 else "fewq")
    for N, M in FST.values():          # FST training fills the card
        assert bwd_plan(128, N, M, HEADS, SMS).splits == 1
    assert bwd_plan(2, 64, 300, HEADS, SMS).splits == 1        # too few keys to split
    assert bwd_plan(1, 20, 17000, HEADS, SMS).splits == 34     # a split of >= 512 keys
    assert bwd_plan(40, 64, 64, HEADS, SMS) == BwdPlan("fewq", 1)
    # both sides above 64: the SIMT pair, unsplit
    assert bwd_plan(1, 65, 65, HEADS, SMS) == BwdPlan("pair", 1)
    assert bwd_plan(2, 1025, 1025, 1, SMS) == BwdPlan("pair", 1)
