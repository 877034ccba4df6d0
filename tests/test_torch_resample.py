"""The port's kaiser_fast resampling == the JAX function, on the same numpy
inputs: the eval sweep's three lower rates from 44.1 kHz, band-limited and
noise clips, ragged lengths.  Both evaluate the same continuous windowed
sinc in f32, so lengths are identical and values agree to f32 rounding."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcaudio.dsp.resample import batched_resample as jax_batched_resample
from pcaudio.dsp.resample import resample_length as jax_resample_length
from pcaudio_torch.dsp.resample import (
    batched_resample, resample, resample_length)

FS = 44100
L = 20480
LENGTHS = np.array([L, 15001, 4097, 777], np.int32)  # ragged, odd


def _clips(kind, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / FS
    w = np.zeros((len(LENGTHS), L), np.float32)
    for i, n in enumerate(LENGTHS):
        if kind == "bandlimited":  # partials well below the lowest Nyquist
            x = sum(rng.uniform(0.1, 0.4) * np.sin(2 * np.pi * f * t
                                                    + rng.uniform(0, 6.3))
                    for f in rng.uniform(50, 4000, 5))
        else:
            x = 0.3 * rng.standard_normal(L)
        w[i, :n] = x[:n]
    return w


@pytest.mark.parametrize("target", [32000, 22050, 11025])
@pytest.mark.parametrize("kind", ["bandlimited", "noise"])
def test_resample_matches_jax(kind, target):
    """Lengths identical; values within 1e-5 of the batch's max |x| (f32
    rounding of two summation orders and of i0 / sinc)."""
    w = _clips(kind)
    ref, ref_len = jax.jit(lambda x, n: jax_batched_resample(x, n, FS, target))(
        jnp.asarray(w), jnp.asarray(LENGTHS))
    got, got_len = batched_resample(torch.from_numpy(w),
                                    torch.from_numpy(LENGTHS), FS, target)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (len(LENGTHS), jax_resample_length(L, FS, target))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(w).max())
    # past each clip's output length the buffer is zero
    pos = np.arange(got.shape[1])[None, :]
    assert not got.numpy()[pos >= got_len.numpy()[:, None]].any()


@pytest.mark.parametrize("n,orig,target", [(220672, 44100, 32000),
                                           (220672, 44100, 22050),
                                           (220672, 44100, 11025),
                                           (777, 44100, 32000),
                                           (1, 44100, 11025)])
def test_resample_length_is_librosas_ceil(n, orig, target):
    assert resample_length(n, orig, target) == jax_resample_length(n, orig, target)
    assert resample_length(n, orig, target) == int(np.ceil(n * target / orig))


def test_one_clip_and_same_rate():
    """``resample`` is the batched function on one clip; the same rate is
    the identity."""
    w = _clips("noise")
    one, n = resample(torch.from_numpy(w[1]), int(LENGTHS[1]), FS, 22050)
    batch, lens = batched_resample(torch.from_numpy(w), torch.from_numpy(LENGTHS),
                                   FS, 22050)
    assert torch.equal(one, batch[1]) and int(n) == int(lens[1])
    x, m = batched_resample(torch.from_numpy(w), torch.from_numpy(LENGTHS), FS, FS)
    assert torch.equal(x, torch.from_numpy(w)) and torch.equal(m, torch.from_numpy(LENGTHS))
