"""The eval sweep's featurizer: the port's ``featurize_batch`` == the JAX
one (the XLA DFT product at precision "highest") at every FST expt-1 window
at 44.1 kHz, at the three lower rates, untrimmed, and on the training
recipes' n_fft/2 path.

Frame masks are identical.  Linear magnitudes: within 1e-5 of each frame's
largest against a float64 transform of the port's own frames, and within
1e-5 of the frame's L2 norm against the JAX package.  The second bar is the
error scale of the JAX package's f32 DFT product, whose sums run over n_fft
terms: on a frame that starts in near-silence and ends in a loud chirp it
sits 1.7e-5 of the frame's largest magnitude from float64, where the port's
``rfft`` sits 5e-7."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcaudio.dsp.featurize import FeaturizeConfig as JaxFeaturizeConfig
from pcaudio.dsp.featurize import featurize_batch as jax_featurize_batch
from pcaudio.dsp.featurize import featurized_max_frames as jax_max_frames
from pcaudio.dsp.stft import stft_window as jax_stft_window
from pcaudio.eval.experiments import sweep_featurize_config as jax_sweep_config
from pcaudio_torch.dsp import (
    FeaturizeConfig, featurize_batch, featurized_max_frames, frame_positions,
    stft_logmag, stft_window, trim_bounds)
from pcaudio_torch.dsp.featurize import trim_and_resample
from pcaudio_torch.eval.experiments import default_list_N, sweep_featurize_config

FS = 44100
L = 24576


def _clips(seed=0):
    """Three ragged clips: noise, a chirp led in by near-silence that the
    60 dB trim cuts, a short tone."""
    rng = np.random.default_rng(seed)
    w = np.zeros((3, L), np.float32)
    t = np.arange(L) / FS
    w[0] = 0.2 * rng.standard_normal(L)
    w[1, :21000] = 0.3 * np.sin(2 * np.pi * (200 + 3000 * t[:21000]) * t[:21000])
    w[1, :3000] = 1e-6 * rng.standard_normal(3000)
    w[2, :9001] = 0.25 * np.sin(2 * np.pi * 440 * t[:9001])
    return w, np.array([L, 21000, 9001], np.int32)


def _jax_cfg(cfg: FeaturizeConfig) -> JaxFeaturizeConfig:
    return JaxFeaturizeConfig(**dataclasses.asdict(cfg))


def _check(cfg: FeaturizeConfig):
    w, n = _clips()
    ref, ref_mask = jax.jit(lambda x, m: jax_featurize_batch(x, m, _jax_cfg(cfg)))(
        jnp.asarray(w), jnp.asarray(n))
    got, got_mask = featurize_batch(torch.from_numpy(w), torch.from_numpy(n), cfg)
    ref, ref_mask = np.asarray(ref), np.asarray(ref_mask)
    assert got.shape == ref.shape
    assert got.shape[1] == featurized_max_frames(L, cfg) == jax_max_frames(L, _jax_cfg(cfg))
    np.testing.assert_array_equal(got_mask.numpy(), ref_mask)
    mag_g = np.exp(got.numpy()[ref_mask].astype(np.float64)) - cfg.log_floor
    mag_r = np.exp(ref[ref_mask].astype(np.float64)) - cfg.log_floor
    norm = np.sqrt((mag_r ** 2).sum(-1, keepdims=True))
    assert (np.abs(mag_g - mag_r) <= 1e-5 * norm).all(), \
        (np.abs(mag_g - mag_r) / norm).max()
    exact = _float64_mag(w, n, cfg)[ref_mask]
    peak = exact.max(-1, keepdims=True)
    assert (np.abs(mag_g - exact) <= 1e-5 * peak).all(), \
        (np.abs(mag_g - exact) / peak).max()


def _float64_mag(w, n, cfg):
    """|STFT| / mag_norm of the port's frames (trimmed, resampled) by a
    float64 transform."""
    x, start, tlen = trim_and_resample(torch.from_numpy(w), torch.from_numpy(n),
                                       cfg)
    t_max = featurized_max_frames(L, cfg)
    pos = frame_positions(start, tlen, cfg.n_fft, t_max, cfg.hop_length)
    frames = torch.gather(x.double(), 1, pos.reshape(len(w), -1)).view(pos.shape)
    frames = frames * stft_window(cfg.n_fft, win_length=cfg.win_length).double()
    norm = cfg.mag_norm if cfg.mag_norm is not None else cfg.n_fft
    return (torch.fft.rfft(frames, dim=-1).abs() / norm).numpy()


@pytest.mark.parametrize("N", default_list_N(2048))
def test_fst_expt1_windows_at_44k(N):
    """The 13 expt-1 windows of the FST recipe (n_fft 2^ceil(log2 N), hop
    N/2, magnitude / N) at the original rate; the config equals the JAX
    one field for field."""
    cfg = sweep_featurize_config(FS, N, fsog=FS, hf=0.5, tDb=60.0)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_sweep_config(FS, N, fsog=FS, hf=0.5, tDb=60.0))
    _check(cfg)


@pytest.mark.parametrize("F", [32000, 0.5 * FS, 0.25 * FS])
def test_lower_rates_at_2048(F):
    """Trim at 44.1 kHz, resample the kept window to F, then the STFT."""
    cfg = sweep_featurize_config(F, 2048, fsog=FS, hf=0.5, tDb=60.0)
    assert cfg.target_fs == int(F)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_sweep_config(F, 2048, fsog=FS, hf=0.5, tDb=60.0))
    _check(cfg)


@pytest.mark.parametrize("target_fs", [None, 22050])
def test_untrimmed(target_fs):
    _check(FeaturizeConfig(fs=FS, target_fs=target_fs, n_fft=2048, trim=False))


@pytest.mark.parametrize("n_fft", [2048, 1024])
def test_recipe_path_unchanged(n_fft):
    """The training recipes' n_fft/2 path: against JAX, and the same
    function as the trim bounds fed straight to ``stft_logmag`` (the
    featurizer before the sweep fields existed), bit for bit; bf16 output
    is the f32 output rounded."""
    cfg = FeaturizeConfig(fs=FS, n_fft=n_fft)
    _check(cfg)
    w, n = (torch.from_numpy(a) for a in _clips())
    got, mask = featurize_batch(w, n, cfg)
    start, tlen = trim_bounds(w, n, top_db=60.0)
    ref, ref_mask = stft_logmag(w, start, tlen, n_fft)
    assert torch.equal(got, ref) and torch.equal(mask, ref_mask)
    half, _ = featurize_batch(w, n, dataclasses.replace(cfg, out_dtype="bfloat16"))
    assert half.dtype == torch.bfloat16 and torch.equal(half, ref.bfloat16())


@pytest.mark.parametrize("n_fft,win", [(2048, 2048), (4096, 3072), (256, 204),
                                       (2048, 1945)])
def test_window_centered_in_frame(n_fft, win):
    np.testing.assert_allclose(stft_window(n_fft, win_length=win).numpy(),
                               np.asarray(jax_stft_window(n_fft, win)),
                               rtol=0, atol=1e-7)
