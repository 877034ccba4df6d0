"""The port's training featurizer, cloud builders, recipe data preparation
and config round-trip == the JAX package's, on a few ~1 s synthetic ESC
clips (pcaudio.data.synthetic.synth_clip)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcaudio.core.config import ExperimentConfig as JaxConfig
from pcaudio.data.synthetic import synth_clip
from pcaudio.dsp.featurize import FeaturizeConfig as JaxFeaturizeConfig
from pcaudio.dsp.featurize import batched_temporal_chunks as jax_chunks
from pcaudio.dsp.featurize import featurize_batch as jax_featurize_batch
from pcaudio.ops import cloud as jax_cloud
from pcaudio.train import recipes as jax_recipes
from pcaudio_torch.core.config import ExperimentConfig
from pcaudio_torch.dsp import (
    FeaturizeConfig, batched_temporal_chunks, featurize_batch)
from pcaudio_torch.eval import TemporalPipelineConfig
from pcaudio_torch.ops import cloud
from pcaudio_torch.train import recipes

FS = 44100
L = 49152  # buffer: 1.1 s


def _clips():
    """Three ~1 s clips of different classes and lengths, one with a
    silent lead-in that the 60 dB trim cuts."""
    lengths = np.array([44100, 40000, 47000], np.int32)
    waves = np.zeros((3, L), np.float32)
    for i, (cls, n) in enumerate(zip((0, 4, 9), lengths)):
        waves[i, :n] = synth_clip(cls, i, seed=3, n=int(n))
    waves[2, :6000] = 0.0
    return waves, lengths, np.array([0, 4, 9], np.int32)


def _assert_logmag_close(got, ref):
    """Rows are frames (or clouds) of log(1e-8 + |X|/n_fft).  An f32
    transform's error scales with the row's energy, not with the bin: in a
    deep spectral null (log-magnitude -15 and below) both the port's rfft
    and the JAX DFT matmul are 3e-3 from a float64 transform in log units.
    So |X| must agree within 1e-5 of the row's largest |X| everywhere, and
    the log-magnitudes within 1e-3 wherever |X| is at least 1e-4 of that
    largest value."""
    mag_g, mag_r = np.exp(got.astype(np.float64)), np.exp(ref.astype(np.float64))
    peak = mag_r.max(-1, keepdims=True)
    assert (np.abs(mag_g - mag_r) <= 1e-5 * peak).all()
    loud = mag_r >= 1e-4 * peak
    np.testing.assert_allclose(got[loud], ref[loud], atol=1e-3, rtol=0)


@pytest.mark.parametrize("n_fft", [2048, 1024])
def test_featurize_batch_matches_jax(n_fft):
    """Frame masks identical; log-magnitudes as _assert_logmag_close (f32
    rfft against the JAX DFT matmul at precision "highest")."""
    waves, lengths, _ = _clips()
    ref, ref_mask = jax.jit(lambda w, n: jax_featurize_batch(
        w, n, JaxFeaturizeConfig(fs=FS, n_fft=n_fft, precision="highest")))(
        jnp.asarray(waves), jnp.asarray(lengths))
    got, got_mask = featurize_batch(torch.from_numpy(waves),
                                    torch.from_numpy(lengths),
                                    FeaturizeConfig(fs=FS, n_fft=n_fft))
    ref_mask = np.asarray(ref_mask)
    np.testing.assert_array_equal(got_mask.numpy(), ref_mask)
    assert got.shape == ref.shape
    _assert_logmag_close(got.numpy()[ref_mask], np.asarray(ref)[ref_mask])
    if n_fft == 1024:
        chunks, cmask = batched_temporal_chunks(got, got_mask, 10)
        rchunks, rcmask = jax_chunks(ref, jnp.asarray(ref_mask), 10)
        np.testing.assert_array_equal(cmask.numpy(), np.asarray(rcmask))
        assert chunks.shape == rchunks.shape


@pytest.mark.parametrize("what", ["resample", "FB", "CNNTemp"])
def test_unported_parts_raise(what):
    """Resampling in the serving pipeline runs on the ``"xla"`` featurize
    path (tests/test_torch_pipeline.py holds it against the JAX package)
    and raises on the fused path, which has no resampler, never running
    something else.  The FB and CNNTemp recipes, which raised until their
    models were ported, now give the JAX package's configs field for
    field."""
    if what == "resample":
        with pytest.raises(ValueError, match="resampling"):
            TemporalPipelineConfig(fs=FS, target_fs=16000,
                                   top_k=128).check_ported()
        TemporalPipelineConfig(fs=FS, target_fs=16000, top_k=128,
                               featurize="xla").check_ported()
        return
    got, ref = recipes.RECIPES[what](), jax_recipes.RECIPES[what]()
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_cloud_builders_match_jax():
    rng = np.random.default_rng(0)
    grid = rng.standard_normal((2, 10, 512)).astype(np.float32)
    frames = rng.standard_normal((4, 1025)).astype(np.float32)
    f, t = cloud.freq_coords(512, FS), cloud.time_coords(10, 1024, FS)
    np.testing.assert_allclose(f.numpy(), np.asarray(jax_cloud.freq_coords(512, FS)),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(t.numpy(), np.asarray(jax_cloud.time_coords(10, 1024, FS)),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        cloud.grid_cloud(torch.from_numpy(grid), f, t).numpy(),
        np.asarray(jax_cloud.grid_cloud(jnp.asarray(grid), jnp.asarray(f.numpy()),
                                        jnp.asarray(t.numpy()))), rtol=0, atol=0)
    f2 = cloud.freq_coords(1025, FS)
    np.testing.assert_array_equal(
        cloud.frame_cloud(torch.from_numpy(frames), f2).numpy(),
        np.asarray(jax_cloud.frame_cloud(jnp.asarray(frames),
                                         jnp.asarray(f2.numpy()))))


@pytest.mark.parametrize("recipe", ["FST", "3ST"])
def test_prepared_data_matches_jax(recipe):
    """Same cloud counts, identical labels, (f, t) coordinates within
    1e-6 and log-magnitudes as _assert_logmag_close, cloud by cloud."""
    waves, lengths, labels = _clips()
    cfg = recipes.RECIPES[recipe]()
    jcfg = jax_recipes.RECIPES[recipe]()
    if recipe == "FST":
        got = recipes.prepare_framewise_data(waves, lengths, labels, cfg, "cpu")
        ref = jax_recipes.prepare_framewise_data(waves, lengths, labels, jcfg,
                                                 as_clouds=True)
    else:
        got = recipes.prepare_temporal_data(waves, lengths, labels, cfg, "cpu")
        ref = jax_recipes.prepare_temporal_data(waves, lengths, labels, jcfg,
                                                as_clouds=True)
    assert got["points"].shape == ref["points"].shape
    assert got["points"].shape[1] == (1025 if recipe == "FST" else 5120)
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_allclose(got["points"][..., :-1], ref["points"][..., :-1],
                               atol=1e-6, rtol=0)
    _assert_logmag_close(got["points"][..., -1], ref["points"][..., -1])


@pytest.mark.parametrize("recipe", ["FST", "3ST"])
def test_reference_json_matches_jax(recipe):
    """to_reference_json writes the JAX package's schema key for key (np_seed
    for the temporal 3ST), and reads back through the alias."""
    got = recipes.RECIPES[recipe]().to_reference_json()
    ref = jax_recipes.RECIPES[recipe]().to_reference_json()
    assert list(got) == list(ref) and got == ref
    back = ExperimentConfig.from_reference_json(got)
    assert back == recipes.RECIPES[recipe]()
    assert back.to_reference_json() == JaxConfig.from_reference_json(
        ref).to_reference_json()
