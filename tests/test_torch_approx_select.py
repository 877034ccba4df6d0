"""The approximate serving selection (``extraction="approx"``): the port's
plan == XLA's reduction plan, its plain selection == an independent numpy
oracle of the window rule, == ``lax.approx_max_k`` where the plan is exact,
and the port's pipeline == the JAX package's on both featurize paths with
``lax.approx_max_k`` replaced by a ``jnp`` form of the same window rule
(on the CPU, XLA's ``approx_max_k`` is an exact top-K).  Kernel K2a is held
against the plain version in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src.lib import _jax

from pcaudio.eval.pipeline import TemporalPipelineConfig as JaxConfig
from pcaudio.eval.pipeline import extract_chunk_clouds as jax_extract
from pcaudio.eval.pipeline import make_chunk_logits as jax_chunk_logits
from pcaudio.eval.pipeline import make_temporal_classifier as jax_classifier
from pcaudio_torch.eval import (
    TemporalPipelineConfig, extract_chunk_clouds, make_chunk_logits,
    make_temporal_classifier)
from pcaudio_torch.eval import pipeline as port_pipeline
from pcaudio_torch.ops.kernels.approx_select import (
    approx_topk_chunks, approx_topk_chunks_plain, approx_topk_plan)
from pcaudio_torch.ops.kernels.select import exact_topk_chunks_plain
from pcaudio_torch.probes.clips import negzero_grid
from pcaudio_torch.serve import AudioClassifier
from test_torch_pipeline import _models, _waves

TOP_K = 128


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: pytest-xdist runs several workers side by
    side, and their default thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def xla_plan(N, K, recall):
    """XLA's own plan function, for a rank-3 operand as the JAX pipeline's."""
    return tuple(_jax.approx_top_k_reduction_output_size(N, 3, K, recall, False, -1))


@pytest.mark.parametrize("recall", [0.8, 0.85, 0.9, 0.95, 0.99, 1.0])
@pytest.mark.parametrize("K", [1, 64, 128, 256])
@pytest.mark.parametrize("N", [512, 1024, 2560, 5120, 5130, 10240])
def test_plan_matches_xla(N, K, recall):
    assert approx_topk_plan(N, K, recall) == xla_plan(N, K, recall)


def test_plan_at_the_serving_shape_and_refusals():
    """N = 10 × 512, K 128: 0.85 and 0.9 share one plan, 0.95 has its own
    (docs/PERFORMANCE.md:85 says all three share one)."""
    assert [approx_topk_plan(5120, 128, r) for r in (0.8, 0.85, 0.9, 0.95, 0.99)] == [
        (640, 3), (1280, 2), (1280, 2), (2560, 1), (5120, 0)]
    assert approx_topk_plan(5130, 128, 0.9) == (1408, 2)
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="recall"):
            approx_topk_plan(5120, 128, bad)
    with pytest.raises(ValueError, match="K="):
        approx_topk_plan(100, 101, 0.9)
    with pytest.raises(ValueError, match="keys"):
        approx_topk_chunks_plain(torch.zeros(2, 10, 512), 128, 0.9)
    with pytest.raises(TypeError):
        approx_topk_chunks_plain(torch.zeros(2, 5120, dtype=torch.float16), 128, 0.9)


def oracle(x, K, M, r):
    """The window rule in numpy, on float32 ``x [R, N]``: pad with -inf to
    2^r · M, window w = max of keys w, w + M, ... (``argmax`` keeps the first,
    lower slab, of equal maxima; numpy compares -0.0 equal to 0.0), the top
    K windows by a lexsort (value descending, then window index), their
    flat indices ascending, the values read from ``x`` (signs of zero
    kept)."""
    R, N = x.shape
    S = 1 << r
    pad = np.full((R, S * M), -np.inf, np.float32)
    pad[:, :N] = x
    slabs = pad.reshape(R, S, M)
    at = np.argmax(slabs, axis=1)
    wmax = np.take_along_axis(slabs, at[:, None], 1)[:, 0]
    idx = np.empty((R, K), np.int64)
    for i in range(R):
        win = np.lexsort((np.arange(M), -wmax[i]))[:K]
        idx[i] = np.sort(at[i, win] * M + win)
    return np.take_along_axis(x, idx, 1), idx


def _keys(kind, R, N, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":        # signed, no ties
        return rng.standard_normal((R, N)).astype(np.float32)
    if kind == "negative":     # log-magnitudes: every key below 0
        return (-1.0 - np.abs(rng.standard_normal((R, N)))).astype(np.float32)
    if kind == "ties":         # 16 signed levels: ties inside and across windows
        return (np.floor(rng.standard_normal((R, N)) * 4.0).clip(-8, 7) / 4.0
                ).astype(np.float32)
    if kind == "negzero":      # 99 % zeros, half of them -0.0
        return negzero_grid(R, -(-N // 10), seed).reshape(R, -1)[:, :N].copy()
    if kind == "equal":        # every key of a row the same
        return np.repeat(rng.uniform(-2, 2, (R, 1)), N, 1).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("N,K,recall", [(5120, 128, 0.9), (5120, 128, 0.8),
                                        (5120, 64, 0.95), (5120, 256, 0.9),
                                        (5130, 128, 0.9), (1000, 64, 0.85),
                                        (5120, 1, 0.9), (5120, 128, 0.99)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["noise", "negative", "ties", "negzero", "equal"])
def test_plain_matches_numpy_oracle(kind, dtype, N, K, recall):
    """Identical indices and values (bit for bit, -0.0 included), in
    ascending flat-index order; N 5130 and 1000 are not multiples of
    128 · 2^r, so the last slab is padded."""
    x = torch.from_numpy(_keys(kind, 4, N, seed=N + K)).to(getattr(torch, dtype))
    M, r = approx_topk_plan(N, K, recall)
    rv, ri = oracle(x.float().numpy(), K, M, r)
    gv, gi = approx_topk_chunks_plain(x, K, recall)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    assert gv.shape == gi.shape == (4, K)
    np.testing.assert_array_equal(gi.numpy(), ri)
    np.testing.assert_array_equal(gv.numpy().view(np.uint32), rv.view(np.uint32))
    assert (np.diff(gi.numpy(), axis=1) > 0).all()
    # the wrapper sends a CPU tensor to the plain version without a launch
    before = approx_topk_chunks.launches
    wv, wi = approx_topk_chunks(x, K, recall)
    assert approx_topk_chunks.launches == before
    assert torch.equal(wi, gi) and torch.equal(wv, gv)


def test_plain_at_r0_is_the_exact_select():
    x = torch.from_numpy(_keys("ties", 3, 5120, seed=5))
    assert approx_topk_plan(5120, 128, 0.99)[1] == 0
    gv, gi = approx_topk_chunks_plain(x, 128, 0.99)
    ev, ei = exact_topk_chunks_plain(x.reshape(3, 1, 5120), 128)
    assert torch.equal(gi, ei) and torch.equal(gv, ev)


@pytest.mark.parametrize("kind", ["noise", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_r0_matches_lax_approx_max_k(kind, dtype):
    """Where XLA's plan is exact (recall 0.99 at N 5120, K 128) the port's
    set equals ``lax.approx_max_k``'s on the CPU, tie-aware: the same
    values as multisets, and the same indices for every value above the
    K-th (equal values at the K-th may be taken in another order)."""
    x = _keys(kind, 3, 5120, seed=11)
    jv, ji = jax.lax.approx_max_k(jnp.asarray(x).astype(dtype)[None], TOP_K,
                                  recall_target=0.99)
    jv = np.asarray(jv.astype(jnp.float32))[0]
    ji = np.asarray(ji)[0]
    gv, gi = approx_topk_chunks_plain(torch.from_numpy(x).to(getattr(torch, dtype)),
                                      TOP_K, 0.99)
    gv, gi = gv.numpy(), gi.numpy()
    for row in range(3):
        np.testing.assert_array_equal(np.sort(gv[row]), np.sort(jv[row]))
        kth = np.sort(jv[row])[0]
        assert set(gi[row][gv[row] > kth]) == set(ji[row][jv[row] > kth])
        if kind == "noise" and dtype == "float32":   # no ties: one set
            assert set(gi[row]) == set(ji[row])


# ---- the pipeline against the JAX package's --------------------------------


def _window_max_k(record):
    """A ``jnp`` form of the window rule with ``lax.approx_max_k``'s
    signature, on XLA's own plan (not the port's), recording its keys and
    indices in ``record``."""
    def approx_max_k(operand, k, recall_target=0.95, **_):
        N = operand.shape[-1]
        M, r = xla_plan(N, k, recall_target)
        S = 1 << r
        lead = operand.shape[:-1]
        x = jnp.pad(operand, [(0, 0)] * len(lead) + [(0, S * M - N)],
                    constant_values=-jnp.inf).reshape(*lead, S, M)
        at = jnp.argmax(x, axis=-2)
        _, win = jax.lax.top_k(jnp.max(x, axis=-2), k)
        idx = jnp.take_along_axis(at, win, -1) * M + win
        record.append((np.asarray(operand.astype(jnp.float32)).reshape(-1, N),
                       np.asarray(idx).reshape(-1, k), (M, r), str(operand.dtype)))
        return jnp.take_along_axis(operand, idx, -1), idx
    return approx_max_k


def _record_port(monkeypatch, record):
    """The port's K2a wrapper in its pipeline, recording keys and indices."""
    def select(keys, k, recall):
        v, i = approx_topk_chunks(keys, k, recall)
        record.append((keys.float().numpy(), i.numpy().astype(np.int64),
                       str(keys.dtype).replace("torch.", "")))
        return v, i
    monkeypatch.setattr(port_pipeline, "approx_topk_chunks", select)


def _kth_window_max(keys, K, M, r):
    """Each row's K-th largest window maximum (ties counted)."""
    R, N = keys.shape
    pad = np.full((R, (1 << r) * M), -np.inf, np.float32)
    pad[:, :N] = keys
    return -np.sort(-pad.reshape(R, 1 << r, M).max(1), axis=1)[:, K - 1]


def _decided_discrete(kj, kp, K, M, r):
    """bf16 keys: a chunk's selection can differ only through a key that
    differs between the two sides and lies at or above the JAX side's
    K-th window maximum on either side; such chunks are undecided."""
    tau = _kth_window_max(kj, K, M, r)[:, None]
    diff = kj != kp
    return ~(diff & ((kj >= tau) | (kp >= tau))).any(1)


def _decided_continuous(kj, kp, K, M, r):
    """f32 keys that differ a little: each key lies in [min(kj, kp),
    max(kj, kp)].  The selection is the same on both sides where, for every
    key in those intervals, each window the JAX side selects keeps its
    winning slab (the winner's lower end above every other slab's upper
    end) and the selected windows' maxima stay above the others' (the least
    lower end of the selected above the largest upper end of the rest)."""
    def slabs(a, fill):
        R, N = a.shape
        out = np.full((R, (1 << r) * M), fill, np.float32)
        out[:, :N] = a
        return out.reshape(R, 1 << r, M)
    J, lo, hi = slabs(kj, -np.inf), slabs(np.minimum(kj, kp), -np.inf), \
        slabs(np.maximum(kj, kp), -np.inf)
    at = np.argmax(J, axis=1)[:, None]
    win_lo = np.take_along_axis(lo, at, 1)[:, 0]
    others = hi.copy()
    np.put_along_axis(others, at, -np.inf, 1)
    stable = win_lo > others.max(1)
    order = np.argsort(-J.max(1), axis=1, kind="stable")
    sel, rest = order[:, :K], order[:, K:]
    sel_lo = np.take_along_axis(win_lo, sel, 1).min(1)
    rest_hi = np.take_along_axis(hi.max(1), rest, 1).max(1)
    return (sel_lo > rest_hi) & np.take_along_axis(stable, sel, 1).all(1)


def _compare(jrec, prec, valid, decided_fn, what, floor):
    (kj, ij, (M, r), jdt), = jrec
    (kp, ip, pdt), = prec
    assert kj.shape == kp.shape and ij.shape == ip.shape and jdt == pdt
    decided = decided_fn(kj, kp, TOP_K, M, r) & valid
    same = np.array([set(a) == set(b) for a, b in zip(ij, ip)])
    assert same[decided].all(), f"{what}: {np.sum(~same[decided])} decided chunks differ"
    print(f"[approx] {what}: plan (M {M}, r {r}); {decided.sum()}/{valid.sum()} "
          f"valid chunks decided, all identical; {same[valid].sum()} identical "
          f"in all")
    assert decided.sum() >= floor * valid.sum(), (decided.sum(), valid.sum())
    return decided


F32 = dict(fs=44100, n_fft=1024, num_frames=10, top_k=TOP_K,
           stft_precision="highest", compute_dtype="float32",
           extraction="approx", approx_recall=0.9)


@pytest.mark.parametrize("featurize", ["xla", "fused"])
def test_pipeline_matches_jax_window_rule(monkeypatch, featurize):
    """f32 "highest" on both featurize paths, ``lax.approx_max_k`` replaced
    by the window rule: the same chunk masks; the same index set in every
    chunk whose selection cannot move under the grids' difference (on the
    ``"xla"`` path the keys are bf16 log-magnitudes, whose roundings the
    JAX DFT product and the port's rfft can put on either side of a bf16
    step; on the fused path f32 |X|², the two grids within 1e-5 of a
    chunk's peak); those chunks' points within 1e-5 (the coordinates are
    the same grid steps, the values the same keys or their logs); their
    chunk logits within 1e-4, the bar of tests/test_torch_pipeline.py's f32
    tests.  At least 3 chunks in 4 must be decided."""
    waves, lengths = _waves(seed=4)
    jm, params, tm = _models(seed=4)
    jrec, prec = [], []
    monkeypatch.setattr(jax.lax, "approx_max_k", _window_max_k(jrec))
    _record_port(monkeypatch, prec)
    kw = dict(F32, featurize=featurize)
    jw, jl = jnp.asarray(waves), jnp.asarray(lengths)
    tw, tl = torch.from_numpy(waves), torch.from_numpy(lengths)
    jcloud, jcm = jax_extract(jw, jl, JaxConfig(**kw))
    cloud, cm = extract_chunk_clouds(tw, tl, TemporalPipelineConfig(**kw))
    jcm = np.asarray(jcm)
    np.testing.assert_array_equal(cm.numpy(), jcm)
    valid = jcm.reshape(-1)
    decided = _compare(jrec, prec, valid, _decided_discrete if featurize == "xla"
                       else _decided_continuous, f"{featurize} f32", 0.75)
    a, b = np.asarray(jcloud.points)[decided], cloud.points.numpy()[decided]
    for x, y in zip(a, b):
        np.testing.assert_allclose(y[np.lexsort(y.T)], x[np.lexsort(x.T)],
                                   atol=1e-5, rtol=0)
    jl_c, _ = jax_chunk_logits(jm, JaxConfig(**kw))(params, jw, jl)
    pl_c, _ = make_chunk_logits(tm, TemporalPipelineConfig(**kw))(tw, tl)
    jl_c = np.asarray(jl_c).reshape(len(valid), -1)
    pl_c = pl_c.numpy().reshape(len(valid), -1)
    np.testing.assert_allclose(pl_c[decided], jl_c[decided], atol=1e-4, rtol=0)


@pytest.mark.parametrize("featurize", ["xla", "fused"])
def test_classifier_matches_jax_window_rule_bf16_serving(monkeypatch, featurize):
    """bf16 serving (``stft_precision="default"``, bf16 clouds) through the
    fused ST (K1's plain version; the JAX fused ST in interpret mode), with
    ``lax.approx_max_k`` replaced by the window rule: the JAX grid takes
    bf16 DFT operands and the port computes it in f32, so selections can
    differ, and the bars are tests/test_torch_pipeline.py's bf16 ones:
    clip logits within 5e-2, and the same argmax except where JAX's top-2
    gap is below twice the largest deviation."""
    waves, lengths = _waves(seed=5)
    jm, params, tm = _models(seed=5)
    jrec, prec = [], []
    monkeypatch.setattr(jax.lax, "approx_max_k", _window_max_k(jrec))
    _record_port(monkeypatch, prec)
    kw = dict(F32, featurize=featurize, stft_precision="default",
              compute_dtype="bfloat16")
    ref = np.asarray(jax_classifier(jm, JaxConfig(**kw), use_fused_st=True)(
        params, jnp.asarray(waves), jnp.asarray(lengths)))
    got = make_temporal_classifier(tm, TemporalPipelineConfig(**kw), use_fused_st=True)(
        torch.from_numpy(waves), torch.from_numpy(lengths)).numpy()
    assert len(jrec) == len(prec) == 1
    assert jrec[0][2] == (1280, 2)
    # bf16 keys on both sides: the "xla" path's cast, the fused path's grid
    assert jrec[0][3] == prec[0][2] == "bfloat16"
    dev = np.abs(got - ref).max()
    assert dev <= 5e-2
    top2 = np.sort(ref, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) >= 2 * dev
    np.testing.assert_array_equal(got.argmax(-1)[decided], ref.argmax(-1)[decided])


@pytest.mark.parametrize("featurize", ["xla", "fused"])
def test_recall_against_the_unpatched_jax_run(featurize, capsys):
    """Unpatched, XLA:CPU's ``approx_max_k`` is an exact top-K: the port's
    window rule is held to no recall floor against it; the recall is
    printed.  Both sides' chunk masks agree."""
    waves, lengths = _waves(seed=6)
    kw = dict(F32, featurize=featurize)
    jcloud, jcm = jax_extract(jnp.asarray(waves), jnp.asarray(lengths),
                              JaxConfig(**kw))
    cloud, cm = extract_chunk_clouds(torch.from_numpy(waves),
                                     torch.from_numpy(lengths),
                                     TemporalPipelineConfig(**kw))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    valid = np.asarray(jcm).reshape(-1)

    def keyset(points):   # (f, t) cells, rounded to the grid steps
        return {(round(float(f) * 1022), round(float(t) * 1e4)) for f, t, _ in points}
    rec = [len(keyset(a) & keyset(b)) / TOP_K for a, b, v in zip(
        np.asarray(jcloud.points), cloud.points.numpy(), valid) if v]
    with capsys.disabled():
        print(f"\n[approx] {featurize} f32, recall 0.9 target: the port's window "
              f"rule keeps {np.mean(rec):.4f} of XLA:CPU's exact set "
              f"(min {np.min(rec):.4f}, {len(rec)} chunks)")
    assert len(rec) > 0 and 0.0 <= np.mean(rec) <= 1.0


def test_flat_selects_the_exact_set_on_both_paths():
    """``extraction="flat"`` serves, and selects what ``"exact"`` does."""
    waves, lengths = _waves(seed=7)
    tw, tl = torch.from_numpy(waves), torch.from_numpy(lengths)
    for featurize in ("fused", "xla"):
        out = {}
        for ex in ("exact", "flat"):
            cfg = TemporalPipelineConfig(**dict(F32, featurize=featurize, extraction=ex))
            out[ex] = extract_chunk_clouds(tw, tl, cfg)[0].points
        assert torch.equal(out["flat"], out["exact"]), featurize


@pytest.mark.parametrize("extraction", ["approx", "flat"])
@pytest.mark.parametrize("featurize", ["fused", "xla"])
def test_audio_classifier_serves_the_mode(featurize, extraction):
    """``AudioClassifier`` takes the mode through its pipeline config: a
    request of clips gives the logits of ``make_temporal_classifier``
    (through K1's plain version, as the classifier serves) on the same
    padded waves."""
    waves, lengths = _waves(seed=8)
    _, _, tm = _models(seed=8)
    cfg = TemporalPipelineConfig(**dict(F32, featurize=featurize, extraction=extraction))
    clf = AudioClassifier(model=tm, pipeline=cfg, batch_size=2,
                          buffer_len=waves.shape[1], device="cpu")
    got = clf.logits([waves[i, :n] for i, n in enumerate(lengths)])
    ref = make_temporal_classifier(tm, cfg, use_fused_st=True)(
        torch.from_numpy(waves), torch.from_numpy(lengths)).numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_stage_probe_edits_apply_to_approx_select_cu():
    """K2a's stage probe (``pcaudio_torch.probes.k2a_stages``) without a
    build: its cuts apply to the current ``csrc/approx_select.cu``, and an
    edit that does not apply raises, naming the missing text."""
    from pcaudio_torch.ops.kernels import _build
    from pcaudio_torch.probes import k2a_stages

    source = (_build.CSRC / "approx_select.cu").read_text()
    srcs = k2a_stages.stage_sources(source)
    assert set(srcs) == set(k2a_stages.STAGES) and srcs["whole"] == source
    assert len(set(srcs.values())) == len(srcs)
    for name, n in k2a_stages.STAGES.items():
        assert f"constexpr int kStopAfter = {n};" in srcs[name]
    with pytest.raises(ValueError, match="kStopAfter = 0"):
        k2a_stages.stage_sources(source.replace("kStopAfter = 0", "kStopAfter = 9"))
