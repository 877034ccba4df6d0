"""The serving ingest: the port's ``AudioClassifier.classify_paths`` == the
JAX package's on the same WAV files and weights (the CPU, plain versions);
int16 staging == f32 staging; the native ring == the Python producer ==
``classify`` on the clips decoded in memory; the loader policy; and
``from_checkpoint`` on what ``save_checkpoint`` writes.

The native ring needs g++; without it the CPU path takes the Python
producer, and the tests that need the ring skip."""
import os
import shutil

import numpy as np
import pytest
import torch

from pcaudio import native as jax_native
from pcaudio.checkpoint import st_params
from pcaudio.eval.pipeline import TemporalPipelineConfig as JaxConfig
from pcaudio.nn import ST as JaxST
from pcaudio.serve import AudioClassifier as JaxClassifier
from pcaudio_torch import native
from pcaudio_torch.checkpoint import save_checkpoint, st_state_dict_from_jax
from pcaudio_torch.core import ExperimentConfig
from pcaudio_torch.data.audio_io import load_wav
from pcaudio_torch.data.synthetic import write_wav_pcm16
from pcaudio_torch.eval import TemporalPipelineConfig
from pcaudio_torch.nn import ST
from pcaudio_torch.serve import AudioClassifier
from pcaudio_torch.train import TrainState

TOP_K = 64
BUFFER = 32768
BATCH = 2
# 7 files in buckets of 2: the last bucket is padded; two clips are longer
# than the buffer (truncated), one is shorter than a chunk
LENGTHS = (30000, 20000, 36000, 9000, 25000, 40000, 15000)
CFG = TemporalPipelineConfig(fs=44100, n_fft=1024, num_frames=10, top_k=TOP_K,
                             stft_precision="highest", compute_dtype="float32")


def _models(seed=0, scale=0.6):
    """A small 3ST in both stacks with the same weights (JAX's carried
    across by ``st_state_dict_from_jax``)."""
    tm = ST(dim_input=3, dim_output=10, num_inds=8, dim_hidden=16, num_heads=4)
    rng = np.random.default_rng(seed)
    sd = {k: rng.uniform(-scale, scale, v.shape).astype(np.float32)
          for k, v in tm.state_dict().items()}
    params = st_params(sd)
    tm.load_state_dict(st_state_dict_from_jax(params))
    jm = JaxST(dim_input=3, dim_output=10, num_inds=8, dim_hidden=16,
               num_heads=4)
    return jm, params, tm.eval()


def _clip(n, i, rng):
    t = np.arange(n) / 44100.0
    tone = 0.3 * np.sin(2 * np.pi * (250.0 * (i + 1)) * t)
    return (tone * np.exp(-t * (i % 3)) + 0.05 * rng.standard_normal(n)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate(LENGTHS):
        p = str(root / f"clip_{i}.wav")
        write_wav_pcm16(p, _clip(n, i, rng))
        paths.append(p)
    return paths


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable: the native ring loader cannot be built")


def _clf(tm, **kw):
    return AudioClassifier(model=tm, pipeline=CFG, batch_size=BATCH,
                           buffer_len=BUFFER, device="cpu", use_fused_st=False,
                           **kw)


def _decoded(paths):
    return [load_wav(p)[0] for p in paths]


def _tie_aware_equal(got, ref):
    dev = np.abs(got - ref).max()
    top2 = np.sort(ref, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) >= 2 * dev
    np.testing.assert_array_equal(got.argmax(-1)[decided], ref.argmax(-1)[decided])
    return decided


@pytest.mark.parametrize("wave_dtype", ["float32", "int16"])
def test_classify_paths_matches_jax(wavs, wave_dtype):
    """Same files and weights: logits within 1e-4 (docs/ACCURACY.md),
    labels equal except near ties; the JAX side as its own tests run it
    here (Pallas featurize and select in interpret mode, f32)."""
    jm, params, tm = _models()
    jcfg = JaxConfig(fs=44100, n_fft=1024, num_frames=10, top_k=TOP_K,
                     featurize="fused", exact_kernel=True,
                     stft_precision="highest", compute_dtype="float32")
    jclf = JaxClassifier(model=jm, params=params, pipeline=jcfg,
                         batch_size=BATCH, buffer_len=BUFFER,
                         use_fused_st=False, wave_dtype=wave_dtype)
    jlabels, jprobs = jclf.classify_paths(wavs)
    # the logits behind them, by the same route classify_paths takes
    ref = (jclf._classify_native(wavs) if jax_native.available()
           else jclf._classify_python(wavs))
    jclf.close()
    clf = _clf(tm, wave_dtype=wave_dtype)
    labels, probs = clf.classify_paths(wavs)
    got = (clf._classify_native(wavs) if native.available()
           else clf._classify_python(wavs))
    clf.close()
    assert got.shape == ref.shape == (len(wavs), 10)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    decided = _tie_aware_equal(got, ref)
    assert decided.sum() >= len(wavs) - 1
    np.testing.assert_array_equal(labels[decided], jlabels[decided])
    np.testing.assert_allclose(probs, jprobs, atol=1e-5)
    # the clips are told apart (no row of zeros or of one repeated clip)
    assert np.ptp(got, axis=0).max() > 1e-2
    assert len({tuple(r) for r in got.round(4)}) == len(wavs)


def test_python_producer_equals_classify(wavs):
    """The Python producer path == ``classify`` on the same clips decoded
    in memory: the same waves in the same buckets, so equal logits."""
    _, _, tm = _models()
    clf = _clf(tm)
    got = clf._classify_python(wavs)
    np.testing.assert_array_equal(got, clf.logits(_decoded(wavs)))


@pytest.mark.parametrize("wave_dtype", ["float32", "int16"])
def test_native_ring_equals_python_producer_and_classify(wavs, gxx, wave_dtype):
    _, _, tm = _models()
    clf = _clf(tm, wave_dtype=wave_dtype)
    labels, _ = clf.classify_paths(wavs)
    assert clf._pf is not None and clf._pf.dtype == getattr(torch, wave_dtype)
    got = clf._classify_native(wavs)
    np.testing.assert_array_equal(got, clf._classify_python(wavs))
    np.testing.assert_array_equal(got, clf.logits(_decoded(wavs)))
    np.testing.assert_array_equal(labels, got.argmax(-1))
    clf.close()


def test_int16_staging_identical_to_f32(wavs, gxx):
    """16-bit sources: int16 slots divided by 32768 on the device give the
    f32 slots' samples exactly, so the logits are identical."""
    _, _, tm = _models()
    outs = {}
    for wd in ("float32", "int16"):
        clf = _clf(tm, wave_dtype=wd)
        outs[wd] = clf._classify_native(wavs)
        clf.close()
    np.testing.assert_array_equal(outs["int16"], outs["float32"])


def test_ring_is_reused_across_calls_and_slots_recycle(wavs, gxx):
    """One ring per classifier, reused by later calls; 13 batches through 6
    slots (slot reuse) give the in-memory logits; ``close`` twice."""
    _, _, tm = _models()
    clf = _clf(tm, wave_dtype="int16")
    many = (wavs * 4)[:25]
    first = clf._classify_native(many)
    pf = clf._pf
    assert pf.depth == clf.MAX_IN_FLIGHT + 2
    np.testing.assert_array_equal(first, clf.logits(_decoded(many)))
    np.testing.assert_array_equal(clf._classify_native(wavs[:3]), first[:3])
    assert clf._pf is pf
    clf.close()
    clf.close()
    assert clf._pf is None


def test_decode_error_raises_and_drops_the_ring(wavs, tmp_path, gxx):
    _, _, tm = _models()
    clf = _clf(tm)
    bad = list(wavs[:3]) + [str(tmp_path / "missing.wav")] + list(wavs[3:])
    with pytest.raises(RuntimeError, match="decode failed: -1"):
        clf.classify_paths(bad)
    assert clf._pf is None  # the ring that held this call's work is gone
    np.testing.assert_array_equal(clf._classify_native(wavs),
                                  clf.logits(_decoded(wavs)))
    clf.close()


def _broken_build(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))


def test_cpu_falls_back_to_the_python_producer(wavs, tmp_path, monkeypatch):
    """device="cpu" keeps the JAX rule: without the native loader the
    Python producer thread decodes."""
    _broken_build(tmp_path, monkeypatch)
    _, _, tm = _models()
    clf = _clf(tm)
    labels, probs = clf.classify_paths(wavs)
    assert clf._pf is None
    ref = clf.logits(_decoded(wavs))
    np.testing.assert_array_equal(labels, ref.argmax(-1))
    np.testing.assert_allclose(probs, torch.softmax(torch.from_numpy(ref), -1)
                               .numpy(), atol=0)


def test_cuda_device_requires_the_native_loader(wavs, tmp_path, monkeypatch):
    """On a CUDA device classify_paths raises when the loader does not
    build, and never falls back to the Python producer."""
    _broken_build(tmp_path, monkeypatch)
    _, _, tm = _models()
    clf = _clf(tm)
    clf.device = torch.device("cuda")  # what a card would give; the loader
    #                                    fails before anything reaches it

    def forbidden(paths):
        raise AssertionError("fell back to the Python producer")
    monkeypatch.setattr(clf, "_classify_python", forbidden)
    with pytest.raises(RuntimeError, match="cannot be built"):
        clf.classify_paths(wavs)


def test_wave_dtype_is_checked():
    _, _, tm = _models()
    with pytest.raises(ValueError, match="wave_dtype"):
        _clf(tm, wave_dtype="float16")


def _save(tmp_path, arch):
    ref_cfg = {"architecture": arch, "window_size": 1024, "hop_factor": 0.5,
               "trim_dB": 60, "sampling_rate": 44100, "classes": 10,
               "dhidden": 16, "nheads": 4, "ninds": 8, "Ntemp": 10,
               "np_seed": 1}
    cfg = ExperimentConfig.from_reference_json(ref_cfg)
    _, _, tm = _models(seed=3)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    state = TrainState(tm, opt)
    save_checkpoint(str(tmp_path), state, cfg, step=2)
    state.model = ST(dim_input=3, dim_output=10, num_inds=8, dim_hidden=16,
                     num_heads=4)  # a later, different step
    save_checkpoint(str(tmp_path), state, cfg, step=5)
    return tm


def test_from_checkpoint_serves_the_saved_model(wavs, tmp_path):
    """The latest ``step_*.pt`` with its ``reference_config.json``: the
    saved weights, the config's pipeline, the saved model's logits."""
    _save(tmp_path, "3ST (Set Transformer Temporal)")
    latest = torch.load(tmp_path / "step_5.pt")["model"]
    clf = AudioClassifier.from_checkpoint(str(tmp_path), top_k=TOP_K,
                                          batch_size=BATCH, buffer_len=BUFFER,
                                          device="cpu")
    for k, v in latest.items():
        assert torch.equal(clf.model.state_dict()[k], v), k
    assert (clf.pipeline.n_fft, clf.pipeline.num_frames, clf.pipeline.top_k,
            clf.pipeline.top_db) == (1024, 10, TOP_K, 60)
    model = ST(dim_input=3, dim_output=10, num_inds=8, dim_hidden=16,
               num_heads=4)
    model.load_state_dict(latest)
    ref = AudioClassifier(model=model, pipeline=clf.pipeline, batch_size=BATCH,
                          buffer_len=BUFFER, device="cpu")
    clips = _decoded(wavs[:3])
    np.testing.assert_array_equal(clf.logits(clips), ref.logits(clips))
    assert AudioClassifier.from_checkpoint(
        str(tmp_path), batch_size=1, device="cpu").pipeline.top_k == 256


def test_from_checkpoint_refuses_fst(tmp_path):
    _save(tmp_path, "FST (Framewise Set Transformer)")
    with pytest.raises(ValueError, match="3ST"):
        AudioClassifier.from_checkpoint(str(tmp_path), device="cpu")
    os.remove(tmp_path / "reference_config.json")
    with pytest.raises(FileNotFoundError):
        AudioClassifier.from_checkpoint(str(tmp_path), device="cpu")
