"""The port's own data modules (``pcaudio_torch/data/``) == the JAX
package's ``pcaudio/data/{audio_io,esc,synthetic}.py``, which they copy:
the same corpus byte for byte, the same seeded split, the same batches."""
import filecmp
import os
import shutil

import numpy as np
import pytest

from pcaudio import native as jax_native
from pcaudio.data import audio_io as jax_audio_io
from pcaudio.data import esc as jax_esc
from pcaudio.data import synthetic as jax_synthetic
from pcaudio_torch import data, native
from pcaudio_torch.data import audio_io, esc, synthetic


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The synthetic ESC-10 corpus, 2 clips a class, written by each side."""
    root = tmp_path_factory.mktemp("corpora")
    port = data.generate_esc_corpus(str(root / "port"), clips_per_class=2)
    ref = jax_synthetic.generate_esc_corpus(str(root / "jax"), clips_per_class=2)
    return port, ref


def test_generated_corpus_is_byte_identical(corpora):
    (csv, audio), (ref_csv, ref_audio) = corpora
    assert open(csv, "rb").read() == open(ref_csv, "rb").read()
    names = sorted(os.listdir(audio))
    assert names == sorted(os.listdir(ref_audio)) and len(names) == 20
    match, mismatch, errors = filecmp.cmpfiles(audio, ref_audio, names, shallow=False)
    assert match == names and not mismatch and not errors


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("seed", [0, 7])
def test_split_waves_match_the_jax_package(corpora, split, seed):
    """The seeded split and its padded batch, on the JAX package's corpus."""
    _, (csv, audio) = corpora
    got = data.load_esc_split_waves(csv, audio, seed, split=split)
    ref = jax_esc.load_esc_split_waves(csv, audio, seed, split=split)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    paths, labels = esc.load_esc(csv, audio)
    rpaths, rlabels = jax_esc.load_esc(csv, audio)
    np.testing.assert_array_equal(paths, rpaths)
    np.testing.assert_array_equal(labels, rlabels)
    np.random.seed(seed)
    split_got = esc.tt_split(paths, labels)
    np.random.seed(seed)
    assert split_got == jax_esc.tt_split(rpaths, rlabels)


def test_pad_batch_and_wav_decode_match_the_jax_package(corpora, tmp_path,
                                                        monkeypatch):
    rng = np.random.default_rng(0)
    clips = [rng.standard_normal(n).astype(np.float32) for n in (5, 300, 1000, 0)]
    for buffer_len in (512, 1000):
        got = data.pad_batch(clips, buffer_len)
        ref = jax_audio_io.pad_batch(clips, buffer_len)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    x = synthetic.synth_clip(3, 1, n=4410)
    np.testing.assert_array_equal(x, jax_synthetic.synth_clip(3, 1, n=4410))
    path = str(tmp_path / "clip.wav")
    synthetic.write_wav_pcm16(path, x)
    got, sr = audio_io.load_wav(path)
    ref, rsr = jax_audio_io.load_wav(path)
    assert sr == rsr == 44100
    np.testing.assert_array_equal(got, ref)
    (_, (csv, audio)) = corpora
    paths = sorted(os.path.join(audio, n) for n in os.listdir(audio))[:3]
    for g, r in zip(audio_io.load_wav_batch(paths, 220672),
                    jax_audio_io.load_wav_batch(paths, 220672, use_native="never")):
        np.testing.assert_array_equal(g, r)
    # "always": the native decoder, == the JAX package's where g++ builds
    # both; it raises "native" where the build fails, never falling back
    if shutil.which("g++") is not None and jax_native.available():
        for g, r in zip(audio_io.load_wav_batch(paths, 220672, use_native="always"),
                        jax_native.decode_wav_batch(paths, 220672)):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="native"):
        audio_io.load_wav_batch(paths, 220672, use_native="always")
    assert esc.ESC10_CATEGORIES == jax_esc.ESC10_CATEGORIES
