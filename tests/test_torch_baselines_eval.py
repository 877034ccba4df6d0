"""The baselines' evaluation sweeps in the port (``pcaudio_torch.eval.
experiments``) == the JAX package's, on the CPU, from the same numpy inputs:
the featurizer with n_fft pinned to the training window (``fixed_nfft``,
windows shorter than n_fft centred in the frame), expt 1 with it, and expt
2's "replace" mode, for FB (frames) and CNN_temp (10-frame chunks).

The models are narrow (FB 129-32-16, CNN 10 x 128 → 32 → 16), their weights
drawn from a numpy seed and carried to JAX through the reference names; the
output bias is centred on the clips' inputs so that the predictions spread
over the classes, and each clip's label is the class the model gives most
of its rows at the training config, so accuracies are neither 0 nor 1.  The
bars are those of tests/test_torch_experiments.py for FST and 3ST: both
stacks compute in f32 and the smallest top-2 gap on these inputs is far
above their deviation, so expt 1's dicts and maxK's must be identical;
randK's draws cannot match ``jax.random``, so it is compared where K keeps
every point."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pcaudio.eval.experiments as jax_ex
from pcaudio import checkpoint as jax_ckpt
from pcaudio.nn import BaselineFF as JaxBaselineFF
from pcaudio.nn import CNNClassifier as JaxCNN
import pcaudio_torch.eval.experiments as ex
from pcaudio_torch.checkpoint import (
    baseline_ff_state_dict_from_jax, cnn_classifier_state_dict_from_jax)
from pcaudio_torch.dsp import FeaturizeConfig, batched_temporal_chunks, featurize_batch
from pcaudio_torch.nn import BaselineFF, CNNClassifier
from test_torch_experiments import FS, NFFT, NTEMP, _corpus
from test_torch_featurize_sweep import _check

FB_DIMS = (NFFT // 2 + 1, 32, 16)
CNN_DIMS = (NFFT // 2, 32, 16)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small CPU ops: one intra-op thread each (as in
    tests/test_torch_experiments.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_rows(w, n, framewise):
    """The training config's inputs (frames or chunks) and their clips."""
    lm, fm = featurize_batch(torch.from_numpy(w), torch.from_numpy(n),
                             FeaturizeConfig(fs=FS, n_fft=NFFT))
    if framewise:
        clip = torch.arange(len(w)).repeat_interleave(lm.shape[1])
        return lm[fm], clip[fm.reshape(-1)]
    chunks, cm = batched_temporal_chunks(lm, fm, NTEMP)
    clip = torch.arange(len(w)).repeat_interleave(chunks.shape[1])
    return chunks[cm], clip[cm.reshape(-1)]


@pytest.fixture(scope="module", params=["FB", "CNN"])
def setup(request):
    """(framewise, waves, lengths, labels, JAX model, JAX params, port
    model)."""
    framewise = request.param == "FB"
    w, n = _corpus()
    if framewise:  # the logits before FB's softmax
        model = BaselineFF(FB_DIMS, nclasses=10)
        logits, last = model.ENC_NN, model.ENC_NN.Code_Linear
    else:
        model = CNNClassifier(NTEMP, NFFT // 2, CNN_DIMS, nclass=10)
        logits, last = model, model.linear.Logits
    rng = np.random.default_rng(5)
    model.load_state_dict({k: torch.from_numpy(rng.uniform(-0.3, 0.3, v.shape).astype(
        np.float32)) for k, v in model.state_dict().items()})
    model.eval()
    rows, clip = _train_rows(w, n, framewise)
    with torch.no_grad():
        last.bias -= logits(rows).mean(0)
        pred = model(rows).argmax(-1)
    labels = np.array([int(torch.mode(pred[clip == b]).values) for b in range(len(w))],
                      np.int32)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    if framewise:
        params = jax_ckpt.baseline_ff_params(sd, num_hidden=2)
        model.load_state_dict(baseline_ff_state_dict_from_jax(params))
        jm = JaxBaselineFF(layer_dims=FB_DIMS, nclasses=10)
    else:
        params = jax_ckpt.cnn_classifier_params(sd, num_hidden=2)
        model.load_state_dict(cnn_classifier_state_dict_from_jax(params))
        jm = JaxCNN(Nt=NTEMP, Nf=NFFT // 2, layer_dims=CNN_DIMS, nclass=10)
    return framewise, w, n, labels, jm, params, model


def _args(setup):
    framewise, w, n, labels, jm, params, model = setup
    return (framewise, (jnp.asarray(w), jnp.asarray(n), jnp.asarray(labels)),
            (w, n, labels), jm, params, model)


def test_expt1_fixed_nfft_matches_jax(setup):
    """FB ``framewise_expt1`` / CNN ``temporal_expt1`` with n_fft pinned to
    the training window: at the full rate and at half of it (trim,
    resample, then the STFT), windows of the training window and a tenth
    of it.  Identical dicts; the default window list stops at Nfft."""
    framewise, jargs, targs, jm, params, model = _args(setup)
    kw = dict(fsog=FS, Nfft=NFFT, fixed_nfft=True,
              list_Fs=[FS, 0.5 * FS], list_N=[NFFT, 25])
    if framewise:
        ref = jax_ex.framewise_expt1(jax_ex.make_fb_frame_classifier(jm, params),
                                     *jargs, **kw)
        got = ex.framewise_expt1(ex.make_fb_frame_classifier(model), *targs,
                                 device="cpu", **kw)
    else:
        ref = jax_ex.temporal_expt1(jax_ex.make_cnn_chunk_classifier(jm, params),
                                    *jargs, Ntemp=NTEMP, **kw)
        got = ex.temporal_expt1(ex.make_cnn_chunk_classifier(model), *targs,
                                Ntemp=NTEMP, device="cpu", **kw)
    assert got == ref
    accs = [a for v in got["data"].values() for a in v]
    assert any(0.0 < a < 1.0 for a in accs) and len(set(accs)) > 1
    assert ex._expt1_lists(FS, NFFT, None, None, True)[1] == \
        jax_ex.default_list_N(NFFT, include_larger=False)
    with pytest.raises(ValueError, match="pinned"):
        ex._expt1_lists(FS, NFFT, None, [2 * NFFT], True)


def test_expt2_replace_matches_jax(setup):
    """FB ``framewise_expt2`` (K 1, 64, 129 of 129 bins) / CNN
    ``temporal_expt2`` (K 1, 640, 1280 of 10 x 128) in mode "replace":
    maxK identical; randK has JAX's keys and lists, and where K keeps every
    bin its mean is the full accuracy and its variance 0 on both."""
    framewise, jargs, targs, jm, params, model = _args(setup)
    kw = dict(fsog=FS, Nfft=NFFT, nruns=2, mode="replace")
    if framewise:
        kw.update(list_K=[1, 64, 129])
        ref = jax_ex.framewise_expt2(jax_ex.make_fb_frame_classifier(jm, params),
                                     None, *jargs, **kw)
        got = ex.framewise_expt2(ex.make_fb_frame_classifier(model), None,
                                 *targs, device="cpu", **kw)
    else:
        kw.update(Ntemp=NTEMP, list_K=[1, 640, 1280])
        ref = jax_ex.temporal_expt2(None, jax_ex.make_cnn_chunk_classifier(jm, params),
                                    *jargs, **kw)
        got = ex.temporal_expt2(None, ex.make_cnn_chunk_classifier(model), *targs,
                                device="cpu", **kw)
    (rnd, mx), (jrnd, jmx) = got, ref
    assert mx == jmx
    accs = [v[0] for v in mx["data"].values()]
    assert len(set(accs)) > 1
    assert rnd["list_K"] == jrnd["list_K"] and list(rnd["data"]) == list(jrnd["data"])
    last = rnd["list_K"][-1]
    assert rnd["data"][last] == jrnd["data"][last] == [mx["data"][last][0], 0.0]
    for mean, var in rnd["data"].values():
        assert 0.0 <= mean <= 1.0 and var >= 0.0


@pytest.mark.parametrize("F", [FS, 0.5 * FS])
@pytest.mark.parametrize("N", [204, 1433, 2048])
def test_pinned_nfft_featurizer_matches_jax(F, N):
    """A window shorter than the pinned n_fft of 2048 is centred in the
    frame, the hop is N/2 and the magnitude is divided by 2048: the config
    equals the JAX one field for field, and the features agree as in
    tests/test_torch_featurize_sweep.py (frame masks identical, |X| within
    1e-5 of the frame's L2 norm of JAX's and of its largest against
    float64)."""
    cfg = ex.sweep_featurize_config(F, N, fsog=FS, hf=0.5, tDb=60.0,
                                    fixed_nfft=2048)
    assert (cfg.n_fft, cfg.win_length, cfg.mag_norm) == (2048, N, 2048.0)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_ex.sweep_featurize_config(
        F, N, fsog=FS, hf=0.5, tDb=60.0, fixed_nfft=2048))
    _check(cfg)


@pytest.mark.parametrize("mode", ["cloud", "replace"])
def test_expt2_modes_need_their_classifier(mode):
    """Mode "replace" runs the grid classifier, "cloud" the cloud
    classifier; another mode is an error."""
    w, n = _corpus()
    calls = []

    def classify(x, *rest):
        calls.append(mode)
        return torch.zeros(x.shape[0], 10)

    one = (classify, None) if mode == "replace" else (None, classify)
    ex.framewise_expt2(*one, w[:1], n[:1], np.zeros(1, np.int32), mode=mode,
                       fsog=FS, Nfft=NFFT, list_K=[1], nruns=1, device="cpu")
    assert calls
    with pytest.raises(ValueError, match="mode"):
        ex.temporal_expt2(classify, classify, w[:1], n[:1], np.zeros(1, np.int32),
                          mode="approx", device="cpu")
