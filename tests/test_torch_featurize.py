"""Wave → trimmed STFT |X|² chunks: the port's plain version == the JAX
Pallas kernel (interpret mode) and the JAX XLA chain.  Kernel K3 is held
against the plain version in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcaudio.dsp.featurize import (
    FeaturizeConfig, batched_temporal_chunks, featurize_batch)
from pcaudio.ops.kernels.featurize import fused_chunk_mag2 as jax_mag2
from pcaudio_torch.ops.kernels.featurize import (
    fused_chunk_mag2, fused_chunk_mag2_plain)

N_FFT = 1024


def _trim_waves(B=3, L=20480, seed=0):
    """tests/test_fused_featurize.py's waves: ragged lengths, and leading
    near-silence / silence that the 60 dB trim cuts."""
    rng = np.random.default_rng(seed)
    waves = np.zeros((B, L), np.float32)
    lengths = np.array([L, 17000, 9000][:B], np.int32)
    for i, n in enumerate(lengths):
        waves[i, :n] = 0.2 * rng.standard_normal(n)
    waves[1, :2048] = 1e-6 * rng.standard_normal(2048)
    waves[2, :1024] = 0.0
    return waves, lengths


@pytest.mark.parametrize("trim", [True, False])
def test_plain_matches_jax_kernel(trim):
    waves, lengths = _trim_waves()
    ref, ref_mask = jax_mag2(jnp.asarray(waves), jnp.asarray(lengths),
                             n_fft=N_FFT, trim=trim, out_dtype=jnp.float32,
                             compute_dtype=jnp.float32)
    got, got_mask = fused_chunk_mag2_plain(
        torch.from_numpy(waves), torch.from_numpy(lengths), trim=trim,
        out_dtype=torch.float32)
    ref, ref_mask = np.asarray(ref), np.asarray(ref_mask)
    np.testing.assert_array_equal(got_mask.numpy(), ref_mask)
    assert got.shape == ref.shape
    # f32 summation order differs (rfft vs a DFT matmul): atol relative to
    # each chunk's largest |X|², plus rtol 1e-4
    for b, c in zip(*np.nonzero(ref_mask)):
        r, g = ref[b, c], got[b, c].numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5 * r.max())


def test_plain_matches_jax_xla_chain_log_form():
    waves, lengths = _trim_waves()
    cfg = FeaturizeConfig(fs=44100, n_fft=N_FFT, trim=True)
    lm, fm = featurize_batch(jnp.asarray(waves), jnp.asarray(lengths), cfg)
    ref, ref_mask = batched_temporal_chunks(lm, fm, 10)
    got, got_mask = fused_chunk_mag2_plain(
        torch.from_numpy(waves), torch.from_numpy(lengths),
        out_dtype=torch.float32)
    ref_mask = np.asarray(ref_mask)
    np.testing.assert_array_equal(got_mask.numpy(), ref_mask)
    logmag = np.log(1e-8 + np.sqrt(got.numpy().astype(np.float64)) / N_FFT)
    # the JAX kernel test's own log-form bar
    np.testing.assert_allclose(logmag[ref_mask], np.asarray(ref)[ref_mask],
                               atol=5e-4, rtol=1e-4)


def test_bf16_grid_is_the_rounded_f32_grid():
    waves, lengths = _trim_waves(seed=1)
    args = torch.from_numpy(waves), torch.from_numpy(lengths)
    g32, m32 = fused_chunk_mag2_plain(*args, out_dtype=torch.float32)
    g16, m16 = fused_chunk_mag2_plain(*args, out_dtype=torch.bfloat16)
    assert torch.equal(m32, m16) and g16.dtype == torch.bfloat16
    assert torch.equal(g16, g32.to(torch.bfloat16))


def test_sub_nfft_clip_fully_masked_and_finite():
    rng = np.random.default_rng(3)
    waves = np.zeros((3, 16384), np.float32)
    waves[:, :700] = 0.1 * rng.standard_normal((3, 700))
    lengths = torch.tensor([700, 300, 1])
    m2, cmask = fused_chunk_mag2_plain(torch.from_numpy(waves), lengths,
                                       out_dtype=torch.float32)
    assert not cmask.any(), "sub-n_fft clips must be fully masked"
    assert torch.isfinite(m2).all()


def test_n_fft_other_than_1024_raises():
    with pytest.raises(ValueError, match="n_fft"):
        fused_chunk_mag2(torch.zeros(1, 16384), torch.tensor([16384]),
                         n_fft=2048)
