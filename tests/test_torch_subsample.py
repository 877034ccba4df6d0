"""``pcaudio_torch.ops.subsample`` against ``pcaudio.ops.subsample`` on the
CPU: every deterministic function exactly (the ranking, the top-K clouds and
their masked form, the replace forms, the importance top-K) or to rtol 1e-5
(the heat-map, whose f32 sums run in another order), the reference goldens
(``tests/golden/ops.npz``, at the JAX tests' own bars), and the random forms
by distribution, since a ``torch.Generator`` cannot give ``jax.random``'s
bits.  Inputs come from numpy seeds."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pcaudio.ops.subsample as jsub
from pcaudio.ops.cloud import frame_cloud as jax_frame_cloud
import pcaudio_torch.ops.subsample as sub
from pcaudio_torch.ops.cloud import frame_cloud, grid_cloud

Z = np.load(os.path.join(os.path.dirname(__file__), "golden", "ops.npz"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(kind, shape=(4, 300), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 2) / 2
    elif kind == "signed_zeros":
        x = np.where(np.abs(x) < 1.0, np.where(x < 0, -0.0, 0.0), x).astype(np.float32)
    elif kind == "all_equal":
        x = np.ones(shape, np.float32)
    return x


def _np_order(x):
    """The documented ``lax.top_k`` order in numpy: a stable descending sort
    (``np.argsort`` compares with ``<``, so -0.0 ties with 0.0)."""
    return np.argsort(-x, axis=-1, kind="stable")


@pytest.mark.parametrize("kind", ["noise", "ties", "signed_zeros", "all_equal"])
@pytest.mark.parametrize("k", [1, 17, 100, 300])
def test_topk_stable_matches_lax_top_k(kind, k):
    """The order ``lax.top_k`` documents (descending, ties to the lower
    index, -0.0 tying with 0.0), the JAX engine's stable argsort
    (``experiments._ranks_desc``) and numpy's, with ``x``'s own values,
    sign of zero included; on tie-free values also ``lax.top_k`` itself.
    XLA:CPU's ``top_k`` does not keep that order among ties at larger k
    (from about k 100 of 300 on here, even the set differs), so tied
    values are held to the stable sorts only."""
    x = _values(kind, (3, 4, 300))
    ji = np.asarray(jnp.argsort(-jnp.asarray(x), axis=-1, stable=True))[..., :k]
    v, i = sub.topk_stable(torch.from_numpy(x), k)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(i.numpy(), _np_order(x)[..., :k])
    jv = np.take_along_axis(x, ji, axis=-1)
    np.testing.assert_array_equal(v.numpy(), jv)
    np.testing.assert_array_equal(np.signbit(v.numpy()), np.signbit(jv))
    if kind == "noise":
        lv, li = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(li))
        np.testing.assert_array_equal(v.numpy(), np.asarray(lv))


def test_topk_stable_bf16():
    x = _values("ties", (5, 513))
    xb = torch.from_numpy(x).bfloat16()
    v, i = sub.topk_stable(xb, 64)
    assert v.dtype == torch.bfloat16
    np.testing.assert_array_equal(i.numpy(), _np_order(xb.float().numpy())[:, :64])


@pytest.mark.parametrize("kind", ["noise", "ties"])
def test_top_k_points_matches_jax(kind):
    """Against the JAX function on tie-free values, against the stable
    order on tied ones."""
    pts = _values(kind, (2, 3, 200, 3))
    for axis in (-1, 0):
        got = sub.top_k_points(torch.from_numpy(pts), 50, value_axis=axis)
        if kind == "noise":
            ref = np.asarray(jsub.top_k_points(jnp.asarray(pts), 50, value_axis=axis))
        else:
            idx = _np_order(pts[..., axis])[..., :50]
            ref = np.take_along_axis(pts, idx[..., None], axis=-2)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n_valid", [[200, 120, 0], [7, 50, 49]])
def test_top_k_points_masked_matches_jax(n_valid):
    """Fewer valid points than k included: every valid point comes before
    the padding, which is taken in index order, and the gathered mask says
    which selections are real.  The valid selections equal the JAX
    function's; the padding's order is held to the stable sort (XLA:CPU's
    ``top_k`` reorders the tied padding)."""
    pts = _values("noise", (3, 200, 3), seed=1)
    mask = np.arange(200)[None, :] < np.array(n_valid)[:, None]
    mask[1, ::3] = False
    got_p, got_m = sub.top_k_points_masked(torch.from_numpy(pts),
                                           torch.from_numpy(mask), 50)
    keyed = np.where(mask, pts[..., -1], np.finfo(np.float32).min)
    idx = _np_order(keyed)[:, :50]
    np.testing.assert_array_equal(got_p.numpy(),
                                  np.take_along_axis(pts, idx[..., None], axis=1))
    np.testing.assert_array_equal(got_m.numpy(), np.take_along_axis(mask, idx, axis=1))
    ref_p, ref_m = jsub.top_k_points_masked(jnp.asarray(pts), jnp.asarray(mask), 50)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    m = got_m.numpy()
    np.testing.assert_array_equal(got_p.numpy()[m], np.asarray(ref_p)[m])
    assert got_m.sum(-1).tolist() == [min(50, int(r.sum())) for r in mask]


@pytest.mark.parametrize("kind", ["noise", "ties", "signed_zeros"])
def test_replace_forms_match_jax(kind):
    """``top_k_replace`` and ``grid_top_k_replace``: the JAX functions' on
    tie-free values, the stable order's kept cells on tied ones."""
    x = _values(kind, (3, 1025))
    g = _values(kind, (2, 3, 10, 64))
    got_x = sub.top_k_replace(torch.from_numpy(x), 100).numpy()
    got_g = sub.grid_top_k_replace(torch.from_numpy(g), 200).numpy()
    if kind == "noise":
        ref_x = np.asarray(jsub.top_k_replace(jnp.asarray(x), 100))
        ref_g = np.asarray(jsub.grid_top_k_replace(jnp.asarray(g), 200))
    else:
        def keep(a, k):
            out = np.zeros_like(a)
            idx = _np_order(a)[..., :k]
            np.put_along_axis(out, idx, np.take_along_axis(a, idx, -1), -1)
            return out
        ref_x = keep(x, 100)
        ref_g = keep(g.reshape(2, 3, -1), 200).reshape(g.shape)
    np.testing.assert_array_equal(got_x, ref_x)
    np.testing.assert_array_equal(got_g, ref_g)


def test_grid_replace_refuses_bad_arguments():
    g = torch.zeros(1, 10, 8)
    with pytest.raises(ValueError, match="generator"):
        sub.grid_top_k_replace(g, 4, flag="rand")
    with pytest.raises(ValueError, match="flag"):
        sub.grid_top_k_replace(g, 4, flag="min")
    with pytest.raises(ValueError, match="generator"):
        sub.importance_indices(torch.ones(1, 10, 8), 4, choice=0)


def _grids_tf():
    return Z["grid"].transpose(2, 1, 0).copy()  # [B, Nt, F]


def _golden_clouds():
    return grid_cloud(torch.from_numpy(_grids_tf()), torch.from_numpy(Z["farr_t"]),
                      torch.from_numpy(Z["tarr"]))


def test_goldens():
    """The reference goldens at tests/test_ops.py's bars."""
    frames = torch.from_numpy(Z["x_frames"].T.copy())
    clouds = frame_cloud(frames, torch.from_numpy(Z["farr"]))
    np.testing.assert_allclose(sub.top_k_points(clouds, 100).numpy(),
                               Z["pc_maxk_clouds"], rtol=1e-6)
    np.testing.assert_allclose(sub.top_k_replace(frames, 100).numpy().T,
                               Z["pc_maxk_replace"], rtol=1e-6)
    grids = torch.from_numpy(_grids_tf())
    np.testing.assert_allclose(sub.top_k_points(_golden_clouds(), 77).numpy(),
                               Z["temp_maxk_clouds"], rtol=1e-6)
    np.testing.assert_allclose(sub.grid_top_k_replace(grids, 200).numpy(),
                               Z["temp_grid_maxk"], rtol=1e-6)
    heat = sub.importance_heatmap(grids, win_f=64)
    got = sub.importance_sample_cloud(_golden_clouds(), heat, k=100, choice=1)
    np.testing.assert_allclose(got.numpy(), Z["temp_imp_top_clouds"],
                               rtol=1e-4, atol=1e-6)
    # the frame clouds the golden top-K came from are the JAX package's
    np.testing.assert_allclose(clouds.numpy(), np.asarray(jax_frame_cloud(
        jnp.asarray(frames.numpy()), jnp.asarray(Z["farr"]))), rtol=0)


@pytest.mark.parametrize("n", [2, 7, 64])
def test_kaiser_taps_match_jax(n):
    """``torch.kaiser_window(n, periodic=True)`` is what the JAX
    ``_kaiser_discrete`` imitates."""
    got = torch.kaiser_window(n, periodic=True, beta=5.09, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsub._kaiser_discrete(n, 5.09)),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("win_f", [2, 5, 8, 64])
def test_importance_heatmap_matches_jax(win_f):
    g = _values("noise", (3, 10, 64), seed=win_f)
    g[0, :, 5:9] = 0.25   # flat runs: gradients of exactly 0
    got = sub.importance_heatmap(torch.from_numpy(g), win_f)
    ref = np.asarray(jsub.importance_heatmap(jnp.asarray(g), win_f))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7)
    assert (got > 0).all()


def test_importance_top_k_matches_jax():
    """choice=1 picks the same flat indices (frequency-major heat), and the
    cloud rows they name are the JAX package's, mismatch and all."""
    grids = _values("noise", (2, 3, 10, 32), seed=4)
    heat_t = sub.importance_heatmap(torch.from_numpy(grids), 8)
    heat_j = jsub.importance_heatmap(jnp.asarray(grids), 8)
    # rank the same heat on both sides: the f32 sums may differ in the last bit
    idx = sub.importance_indices(heat_t, 100, choice=1)
    ref = jsub.importance_indices(jnp.asarray(heat_t.numpy()), 100, choice=1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))
    assert (idx.numpy() == np.asarray(jsub.importance_indices(heat_j, 100, 1))).mean() > 0.97
    clouds = grid_cloud(torch.from_numpy(grids), torch.linspace(0, 0.5, 32),
                        torch.linspace(0, 0.1, 10))
    got = sub.importance_sample_cloud(clouds, heat_t, 100, choice=1)
    want = jsub.importance_sample_cloud(jnp.asarray(clouds.numpy()),
                                        jnp.asarray(heat_t.numpy()), 100, choice=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _chi2_ok(counts, expected):
    """Pearson's chi-square within 6 standard deviations of its mean (a
    fixed seed: the check is deterministic, the margin generous)."""
    counts, expected = np.asarray(counts, float), np.asarray(expected, float)
    stat = float(((counts - expected) ** 2 / expected).sum())
    df = len(counts) - 1
    return stat <= df + 6 * np.sqrt(2 * df), stat


def test_rand_k_points_uniform():
    """Without replacement (k distinct points a cloud), each point chosen
    with probability k / n."""
    n, k, trials = 40, 10, 4000
    pts = torch.arange(n, dtype=torch.float32)[None, :, None].expand(trials, n, 2)
    gen = torch.Generator().manual_seed(0)
    got = sub.rand_k_points(gen, pts.contiguous(), k)[..., 0].long()
    assert got.shape == (trials, k)
    assert all(len(set(r)) == k for r in got.tolist())
    ok, stat = _chi2_ok(torch.bincount(got.reshape(-1), minlength=n).numpy(),
                        np.full(n, trials * k / n))
    assert ok, stat


def test_rand_k_points_masked_uniform_over_valid():
    n, k, trials = 30, 6, 4000
    mask = torch.zeros(trials, n, dtype=torch.bool)
    mask[:, ::2] = True                      # 15 valid points
    mask[0, :] = False
    mask[0, :3] = True                       # a cloud with fewer valid than k
    pts = torch.arange(n, dtype=torch.float32)[None, :, None].expand(trials, n, 3)
    gen = torch.Generator().manual_seed(1)
    p, m = sub.rand_k_points_masked(gen, pts.contiguous(), mask, k)
    idx = p[..., 0].long()
    assert m[0].tolist() == [True] * 3 + [False] * 3
    assert sorted(idx[0, :3].tolist()) == [0, 1, 2]
    rest = idx[1:]
    assert m[1:].all() and (rest % 2 == 0).all()
    counts = torch.bincount(rest.reshape(-1), minlength=n).numpy()[::2]
    ok, stat = _chi2_ok(counts, np.full(15, (trials - 1) * k / 15))
    assert ok, stat


def test_rand_k_replace_uniform():
    n, k, trials = 50, 5, 4000
    x = torch.arange(1, n + 1, dtype=torch.float32).expand(trials, n).contiguous()
    gen = torch.Generator().manual_seed(2)
    got = sub.rand_k_replace(gen, x, k)
    kept = got != 0
    assert (kept.sum(-1) == k).all() and torch.equal(got[kept], x[kept])
    ok, stat = _chi2_ok(kept.sum(0).numpy(), np.full(n, trials * k / n))
    assert ok, stat
    g = x.reshape(trials, 5, 10)
    out = sub.grid_top_k_replace(g, k, flag="rand", generator=gen)
    assert out.shape == g.shape and ((out != 0).sum((-1, -2)) == k).all()


def test_importance_multinomial_follows_the_heat():
    """choice=0 draws with replacement, index i (of the frequency-major
    flattening) with probability heat_i / Σ heat, as the JAX
    ``categorical`` over log heat does."""
    rng = np.random.default_rng(5)
    heat = torch.from_numpy(rng.uniform(0.1, 1.0, (4, 6)).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    idx = sub.importance_indices(heat[None].expand(2000, 4, 6), 50, choice=0,
                                 generator=gen)
    assert idx.shape == (2000, 50)
    p = heat.T.reshape(-1) / heat.sum()
    ok, stat = _chi2_ok(torch.bincount(idx.reshape(-1), minlength=24).numpy(),
                        (p * idx.numel()).numpy())
    assert ok, stat
    clouds = torch.arange(24, dtype=torch.float32)[None, :, None].expand(3, 24, 3)
    got = sub.importance_sample_cloud(clouds, heat[None].expand(3, 4, 6), 10, 0, gen)
    assert got.shape == (3, 10, 3)


@pytest.mark.parametrize("kind", ["noise", "ties", "signed_zeros"])
def test_replace_mode_keeps_the_same_cells(kind):
    """Expt 2's "replace" mode (``experiments._ranks_desc`` < K over the
    grid flattened frequency-fastest) keeps exactly the cells
    ``grid_top_k_replace`` keeps: one ranking for both."""
    from pcaudio_torch.eval.experiments import _ranks_desc

    g = torch.from_numpy(_values(kind, (4, 10, 64), seed=7))
    for K in (1, 100, 640):
        keep = (_ranks_desc(g.reshape(4, -1)) < K).reshape(g.shape)
        np.testing.assert_array_equal(torch.where(keep, g, 0.0).numpy(),
                                      sub.grid_top_k_replace(g, K).numpy())
