"""The premises of kernel K3's frame pass (``pcaudio_torch/csrc/featurize.cu``),
on the CPU:

- on the plain index map (``dsp/stft.py``), frame t of a clip trimmed to
  ``[start, start + tlen)`` with a hop-aligned ``start`` is the raw window
  ``x[start + (t-1)·512, start + (t+1)·512)`` for ``1 <= t < t_last = tlen //
  512``, and frames 0 and t_last are not;
- the real-input form (one 512-point complex FFT of the even and odd
  samples, then one twiddle pass pairing bin k with bin 512 - k) gives
  ``torch.fft.rfft``'s |X|², k = 0 included;
- the three radix-8 passes in the kernel's order are the 512-point FFT.

Imports no jax."""
import numpy as np
import pytest
import torch

from pcaudio_torch.dsp import frame_positions, stft_window

N_FFT, HOP = 1024, 512
T_LASTS = (0, 1, 2, 9, 42)


@pytest.mark.parametrize("tail", [0, 1, 511])
@pytest.mark.parametrize("s0", [0, 1, 2, 37])
def test_inner_frames_are_raw_hop_aligned_windows(s0, tail):
    """One clip per t_last in T_LASTS, trimmed to start s0·512 and tlen
    t_last·512 + tail."""
    start = torch.full((len(T_LASTS),), s0 * HOP)
    tlen = torch.tensor([t * HOP + tail for t in T_LASTS])
    n_frames = max(T_LASTS) + 3
    pos = frame_positions(start, tlen, N_FFT, n_frames)
    for b, t_last in enumerate(T_LASTS):
        if tlen[b] == 0:
            continue
        y0 = s0 * HOP
        for t in range(n_frames):
            raw = torch.arange(y0 + (t - 1) * HOP, y0 + (t + 1) * HOP)
            same = torch.equal(pos[b, t], raw)
            assert same == (1 <= t < t_last), (b, t, t_last)
            # every position lies in the clip, whatever the frame
            assert y0 <= int(pos[b, t].min()) and int(pos[b, t].max()) < y0 + tlen[b]
        if t_last >= 2:
            # the n = t_last - 1 raw frames span (n + 1)·512 distinct samples
            assert torch.equal(torch.unique(pos[b, 1:t_last]),
                               torch.arange(y0, y0 + t_last * HOP))


def test_empty_clip_reads_its_start_only():
    pos = frame_positions(torch.tensor([3 * HOP]), torch.tensor([0]), N_FFT, 4)
    assert bool((pos == 3 * HOP).all())


def _half_length_mag2(x: torch.Tensor) -> torch.Tensor:
    """|X[k]|², k < 512, of real frames x [..., 1024] from one 512-point
    complex FFT of z[n] = x[2n] + i x[2n+1] (the kernel's real-input form)."""
    n = x.shape[-1] // 2
    Z = torch.fft.fft(torch.complex(x[..., 0::2], x[..., 1::2]))
    Zc = torch.conj(Z[..., (-torch.arange(n)) % n])      # conj Z[512 - k]
    E = (Z + Zc) / 2
    O = (Z - Zc) / 2j
    k = torch.arange(n, dtype=x.dtype)
    W = torch.polar(torch.ones_like(k), -torch.pi * k / n)   # W1024^k
    X = E + W * O
    return X.real ** 2 + X.imag ** 2


def _frames(dtype):
    rng = np.random.default_rng(11)
    t = np.arange(N_FFT)
    rows = [rng.standard_normal(N_FFT),                  # noise
            np.sin(2 * np.pi * 37.3 * t / N_FFT),        # a tone
            np.cos(2 * np.pi * 511 * t / N_FFT),         # next to Nyquist
            np.ones(N_FFT),                              # DC only
            np.eye(1, N_FFT, 0)[0], np.eye(1, N_FFT, 1)[0],  # impulses
            1e-6 * rng.standard_normal(N_FFT)]
    x = torch.tensor(np.stack(rows), dtype=dtype)
    return x * stft_window(N_FFT).to(dtype)


@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_real_input_form_matches_rfft(dtype, rel):
    x = _frames(dtype)
    ref = torch.fft.rfft(x)[..., :N_FFT // 2]
    ref = ref.real ** 2 + ref.imag ** 2
    got = _half_length_mag2(x)
    scale = ref.amax(dim=-1, keepdim=True)
    assert bool(((got - ref).abs() <= rel * scale).all())
    # k = 0 pairs Z[0] with itself: X[0] = Re Z[0] + Im Z[0] = sum of x
    dc = x.double().sum(-1) ** 2
    assert bool(((got[..., 0] - dc).abs() <= rel * scale[..., 0]).all())
    # a silent frame stays exactly 0
    assert not _half_length_mag2(torch.zeros(2, N_FFT, dtype=dtype)).any()


def _dft8(a):
    """8-point DFT over axis 0."""
    return np.fft.fft(a, axis=0)


def test_three_radix8_passes_are_the_512_point_fft():
    """The kernel's order: thread j holds z[j + 64m]; pass 1 transforms
    over m -> m' with twiddle W512^(j m'); pass 2 over j1 (j = j0 + 8 j1)
    -> r with twiddle W64^(j0 r); pass 3 over j0 -> k''; bin
    m' + 8r + 64k''."""
    rng = np.random.default_rng(2)
    z = rng.standard_normal(512) + 1j * rng.standard_normal(512)
    j = np.arange(64)
    a = _dft8(z.reshape(8, 64))                             # [m', j]
    a *= np.exp(-2j * np.pi * np.outer(np.arange(8), j) / 512)
    a = a.reshape(8, 8, 8)                                  # [m', j1, j0]
    b = _dft8(np.moveaxis(a, 1, 0))                         # [r, m', j0]
    b *= np.exp(-2j * np.pi * np.outer(np.arange(8), np.arange(8))
                / 64)[:, None, :]
    c = _dft8(np.moveaxis(b, 2, 0))                         # [k'', r, m']
    Z = np.empty(512, complex)
    k2, r, mp = np.meshgrid(np.arange(8), np.arange(8), np.arange(8),
                            indexing="ij")
    Z[mp + 8 * r + 64 * k2] = c
    np.testing.assert_allclose(Z, np.fft.fft(z), rtol=0, atol=1e-10)
