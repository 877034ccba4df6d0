"""The port's evaluation sweeps (``pcaudio_torch.eval.experiments``) == the
JAX package's (``pcaudio.eval.experiments``), on the CPU, from the same
numpy inputs: the default lists, the sweep featurizer's configs, the rank
engine, and the four experiment functions on a tiny synthetic corpus.

Weights cross with ``st_state_dict_from_jax``; the JAX sweeps run their XLA
path (plain attention, no Pallas).  The narrow ST is drawn from a numpy seed
and its output bias is centred on the test clips' clouds, so that its
predictions spread over the classes instead of naming one class for every
cloud; each clip's label is the class the model gives most of its frames at
the training config, so that accuracies are neither 0 nor 1 and move with
every row.  Both stacks compute in f32 and differ by about 1e-6 in the
logits, where the smallest top-2 gap of these models on these clips is
above 1e-3: the tie-aware rule (a row may differ only if its top-2 gap is
within twice the logit deviation) excuses no row, so the accuracies and
counts must be identical.  The random-K draws cannot match ``jax.random``
bit for bit: the engine test feeds the port the ranks made from JAX's noise,
and the whole-slice tests compare randK where K keeps every point."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pcaudio.eval.experiments as jax_ex
from pcaudio.checkpoint import st_params
from pcaudio.dsp.featurize import FeaturizeConfig as JaxFeaturizeConfig
from pcaudio.dsp.featurize import featurize_batch as jax_featurize_batch
from pcaudio.nn import ST as JaxST
from pcaudio.ops.cloud import frame_cloud as jax_frame_cloud
from pcaudio.ops.cloud import freq_coords as jax_freq_coords
from pcaudio.ops.cloud import grid_cloud as jax_grid_cloud
from pcaudio.ops.cloud import time_coords as jax_time_coords
import pcaudio_torch.eval.experiments as ex
from pcaudio_torch.checkpoint import st_state_dict_from_jax
from pcaudio_torch.data.synthetic import synth_clip
from pcaudio_torch.dsp import FeaturizeConfig, batched_temporal_chunks, featurize_batch
from pcaudio_torch.nn import ST
from pcaudio_torch.ops.cloud import frame_cloud, freq_coords, grid_cloud, time_coords

FS = 44100
NFFT = 256
NTEMP = 10
L = 18432
WIDTH = dict(dim_output=10, num_inds=4, dim_hidden=8, num_heads=2)


def _corpus():
    """Six ragged clips of the synthetic corpus' first six classes."""
    w = np.zeros((6, L), np.float32)
    n = np.zeros(6, np.int32)
    for i in range(6):
        c = synth_clip(i, i, n=int(0.4 * FS) - 700 * i)
        w[i, :len(c)], n[i] = c, len(c)
    return w, n


def _train_rows(w, n, din):
    """The training config's clouds: FST frames (din 2) or 3ST chunks."""
    lm, fm = featurize_batch(torch.from_numpy(w), torch.from_numpy(n),
                             FeaturizeConfig(fs=FS, n_fft=NFFT))
    if din == 2:
        frames = lm[fm]
        clip = torch.arange(len(w)).repeat_interleave(lm.shape[1])[fm.reshape(-1)]
        return frame_cloud(frames, freq_coords(frames.shape[-1], FS)), clip
    chunks, cm = batched_temporal_chunks(lm, fm, NTEMP)
    flat = chunks[cm]
    clip = torch.arange(len(w)).repeat_interleave(chunks.shape[1])[cm.reshape(-1)]
    return grid_cloud(flat, freq_coords(flat.shape[-1], FS),
                      time_coords(NTEMP, NFFT, FS)), clip


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small CPU ops: one intra-op thread each, or workers
    running side by side (pytest-xdist) oversubscribe the cores and the
    ops' thread handoffs take most of the time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[2, 3], ids=["FST", "3ST"])
def setup(request):
    """(din, waves, lengths, labels, JAX model, JAX params, port model)."""
    din = request.param
    w, n = _corpus()
    model = ST(dim_input=din, **WIDTH)
    rng = np.random.default_rng(din)
    model.load_state_dict({k: torch.from_numpy(rng.uniform(-1, 1, v.shape).astype(
        np.float32)) for k, v in model.state_dict().items()})
    clouds, clip = _train_rows(w, n, din)
    with torch.no_grad():
        model.dec[1].bias -= model(clouds).mean(0)
        pred = model(clouds).argmax(-1)
    labels = np.array([int(torch.mode(pred[clip == b]).values) for b in range(len(w))],
                      np.int32)
    params = st_params({k: v.numpy() for k, v in model.state_dict().items()})
    model.load_state_dict(st_state_dict_from_jax(params))
    return din, w, n, labels, JaxST(dim_input=din, **WIDTH), params, model.eval()


@pytest.mark.parametrize("Nfft", [2048, 1024, 256])
def test_default_lists_match_jax(Nfft):
    for larger in (True, False):
        assert ex.default_list_N(Nfft, larger) == jax_ex.default_list_N(Nfft, larger)
    assert ex.default_list_K(Nfft // 2) == jax_ex.default_list_K(Nfft // 2)
    assert ex.default_list_K(Nfft * 5) == jax_ex.default_list_K(Nfft * 5)
    got, ref = ex.default_list_Fs(44100), jax_ex.default_list_Fs(44100)
    assert got == ref and [type(f) for f in got] == [type(f) for f in ref]


@pytest.mark.parametrize("kind", ["noise", "ties", "signed_zeros", "logmag"])
def test_ranks_desc_matches_jax(kind):
    """The same ranks as the JAX engine's stable descending argsort (ties to
    the lower index; -0.0 ties with 0.0)."""
    rng = np.random.default_rng(3)
    x = rng.random((5, 300)).astype(np.float32)
    if kind == "ties":
        x = np.floor(x * 4) / 4
    elif kind == "signed_zeros":
        x = np.where(x < 0.5, np.where(x < 0.25, -0.0, 0.0), x).astype(np.float32)
    elif kind == "logmag":
        w, n = _corpus()
        lm, _ = featurize_batch(torch.from_numpy(w), torch.from_numpy(n),
                                FeaturizeConfig(fs=FS, n_fft=NFFT))
        x = lm[:, :5].reshape(-1, lm.shape[-1]).numpy()
    got = ex._ranks_desc(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ex._ranks_desc(jnp.asarray(x))))
    assert sorted(got[0].tolist()) == list(range(x.shape[-1]))


def test_mask_counts_with_jax_ranks(setup):
    """One microbatch of the expt-2 engine: the port's counting, fed the
    ranks the JAX engine makes (from its own uniform noise), gives the JAX
    engine's maxK and randK counts."""
    din, w, n, labels, jm, params, model = setup
    R, Ks = 2, [1, 40, 129]
    lm, fm = jax.jit(lambda x, m: jax_featurize_batch(
        x, m, JaxFeaturizeConfig(fs=FS, n_fft=NFFT)))(jnp.asarray(w[:2]),
                                                     jnp.asarray(n[:2]))
    labels = labels[:2]
    if din == 2:
        rows, valid, rlabels = jax_ex._valid_frames(lm, fm, jnp.asarray(labels))
        clouds = jax_frame_cloud(rows, jax_freq_coords(rows.shape[-1], FS))
        src = rows
    else:
        from pcaudio.dsp.featurize import batched_temporal_chunks as jax_chunks
        ch, cm = jax_chunks(lm, fm, NTEMP)
        rows = ch.reshape(-1, *ch.shape[2:])
        valid, rlabels = cm.reshape(-1), jnp.repeat(jnp.asarray(labels), ch.shape[1])
        clouds = jax_grid_cloud(rows, jax_freq_coords(rows.shape[-1], FS),
                                jax_time_coords(NTEMP, NFFT, FS))
        src = rows.reshape(rows.shape[0], -1)
        Ks = [1, 500, 1280]
    kmb = jax.random.fold_in(jax.random.key(0), 0)
    ref_max, ref_rand = jax.jit(lambda c, s, lab, v, k: jax_ex._prefix_mask_counts(
        lambda x, keep: jm.apply(params, x, mask=keep), c, s, lab, v, k,
        jnp.asarray(Ks), R))(clouds, src, rlabels, valid, kmb)
    rmax = jax_ex._ranks_desc(src)
    rrand = jax_ex._ranks_desc(jax.random.uniform(kmb, (R,) + src.shape))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got_max, got_rand = ex._mask_counts(
        ex.make_cloud_classifier(model), t(clouds), t(rmax).long(),
        t(rrand).long(), t(rlabels).long(), t(valid), Ks)
    np.testing.assert_array_equal(got_max.numpy(), np.asarray(ref_max))
    np.testing.assert_array_equal(got_rand.numpy(), np.asarray(ref_rand))
    assert 0 < int(got_max[-1]) < int(np.asarray(valid).sum())


def _jax_and_port(setup):
    din, w, n, labels, jm, params, model = setup
    return (din, (jnp.asarray(w), jnp.asarray(n), jnp.asarray(labels)),
            (w, n, labels), jm, params, model)


LISTS = dict(list_Fs=[0.5 * FS], list_N=[512, 25])


def test_expt1_matches_jax(setup):
    """FST ``framewise_expt1`` / 3ST ``temporal_expt1`` at half the rate
    (trim, resample, then the STFT) and two windows, twice and a tenth of
    the training window: identical dicts (the full rate and the other
    windows: tests/test_torch_featurize_sweep.py)."""
    din, jargs, targs, jm, params, model = _jax_and_port(setup)
    if din == 2:
        ref = jax_ex.framewise_expt1(jax_ex.make_fst_frame_classifier(jm, params),
                                     *jargs, fsog=FS, Nfft=NFFT, **LISTS)
        got = ex.framewise_expt1(ex.make_fst_frame_classifier(model), *targs,
                                 fsog=FS, Nfft=NFFT, device="cpu", **LISTS)
    else:
        ref = jax_ex.temporal_expt1(jax_ex.make_3st_chunk_classifier(jm, params),
                                    *jargs, fsog=FS, Nfft=NFFT, Ntemp=NTEMP, **LISTS)
        got = ex.temporal_expt1(ex.make_3st_chunk_classifier(model), *targs,
                                fsog=FS, Nfft=NFFT, Ntemp=NTEMP, device="cpu",
                                **LISTS)
    assert got == ref
    accs = [a for v in got["data"].values() for a in v]
    assert any(0.0 < a < 1.0 for a in accs) and len(set(accs)) > 1


def test_expt2_matches_jax(setup):
    """FST ``framewise_expt2`` (K 1, 64, 129 of 129 points) / 3ST
    ``temporal_expt2`` (K 1, 640, 1280 of 1280 points): maxK identical;
    randK has JAX's keys and lists, and where K keeps every point its mean
    is the full accuracy and its variance 0 on both."""
    din, jargs, targs, jm, params, model = _jax_and_port(setup)
    kw = dict(fsog=FS, Nfft=NFFT, nruns=2, mode="cloud")
    if din == 2:
        kw.update(list_K=[1, 64, 129])
        ref = jax_ex.framewise_expt2(None, jax_ex.make_cloud_classifier(jm, params),
                                     *jargs, **kw)
        got = ex.framewise_expt2(None, ex.make_cloud_classifier(model), *targs,
                                 device="cpu", **kw)
    else:
        kw.update(Ntemp=NTEMP, list_K=[1, 640, 1280])
        ref = jax_ex.temporal_expt2(jax_ex.make_cloud_classifier(jm, params), None,
                                    *jargs, **kw)
        got = ex.temporal_expt2(ex.make_cloud_classifier(model), None, *targs,
                                device="cpu", **kw)
    (rnd, mx), (jrnd, jmx) = got, ref
    assert mx == jmx
    assert rnd["list_K"] == jrnd["list_K"] and list(rnd["data"]) == list(jrnd["data"])
    last = rnd["list_K"][-1]
    assert rnd["data"][last] == jrnd["data"][last] == [mx["data"][last][0], 0.0]
    for mean, var in rnd["data"].values():
        assert 0.0 <= mean <= 1.0 and var >= 0.0


@pytest.mark.parametrize("F,N", [(44100, 2048), (32000, 2048), (22050.0, 4096),
                                 (11025.0, 204)])
def test_sweep_featurize_config_matches_jax(F, N):
    got = ex.sweep_featurize_config(F, N, fsog=FS, hf=0.5, tDb=60.0)
    ref = jax_ex.sweep_featurize_config(F, N, fsog=FS, hf=0.5, tDb=60.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert (got.hop_length, got.num_bins) == (ref.hop_length, ref.num_bins)
