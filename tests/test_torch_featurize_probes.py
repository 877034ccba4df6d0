"""The K3-family probe kernels' plain versions
(``pcaudio_torch.ops.kernels.featurize_probes``) == the TPU probe scripts'
Pallas kernels run in interpret mode on the CPU, at small sizes, from the
same numpy inputs.

The eleven kernel bodies are closures inside the scripts' ``main()``:
``scripts/probe_int16_load.py`` (``kern``, ``kern2``),
``scripts/probe_chunk_relayout.py`` (``k_pass``, ``k_reshape``),
``scripts/probe_featurize_blockc.py`` (``k_unroll``, ``k_stack``) and
``scripts/profile_featurize_variants.py`` (``k_matmul``, ``k_matmul_f``,
``k_scratch``, ``k_full``, ``k_nozero``).  Their bodies are copied below
verbatim, with the sizes that ``main()`` fixes made arguments, and called
through ``pallas_call``s built as the scripts build them.  The CUDA kernels
are held against the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 8).
"""
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pcaudio_torch.ops.kernels.featurize_probes import (
    chunk_relayout, chunk_relayout_plain, dft_mag2, dft_mag2_bound, dft_mag2_plain,
    dft_rows_per_block, dft_written, int16_gram, int16_gram_plain, wave_block_sums,
    wave_block_sums_plain)
from pcaudio_torch.ops.kernels.probes import matmul_bound
from pcaudio_torch.probes import (
    PROBES, chunk_relayout as p7, featurize_blockc as p8, featurize_variants as p9,
    int16_load as p6)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the DFT probes at a small size: hop 16, F 16 (n_fft 32), 4-frame chunks,
# R 21 frames, so C·Nt = 20 = R − 1 as at the scripts' sizes (431, 430)
HOP, F, NT, R = 16, 16, 4, 21
C = (1 + R) // NT
N_CLIPS = 8


def _assert_within(got, ref, bound, what):
    """|got − ref| ≤ bound elementwise."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    bound = np.broadcast_to(np.asarray(bound, np.float64), err.shape)
    assert (err <= bound).all(), (
        f"{what}: max |err| {err.max():.3e} at bound "
        f"{bound.flat[int(np.argmax(err - bound))]:.3e}")


# ---- P6: int16 waves -------------------------------------------------------

def script_kern(x_ref, o_ref):
    """``probe_int16_load.py:18`` (``kern``), verbatim."""
    x = x_ref[...].astype(jnp.float32) * (1.0 / 32768.0)
    o_ref[...] = jnp.dot(x, x.T, preferred_element_type=jnp.float32)


def script_kern2(x_ref, o_ref):
    """``probe_int16_load.py:38`` (``kern2``), verbatim."""
    c = pl.program_id(0)
    x = x_ref[0].astype(jnp.float32)
    o_ref[c, 0] = jnp.sum(x)


def test_int16_gram_plain_matches_script_kern():
    """int16 → f32·(1/32768) is exact on both sides; the f32 products
    within matmul_bound (2·(L + 1)·2^-24·Σ|a||b|).  The script's sizes
    (64 x 512) and values."""
    B, L = 64, 512
    x = np.random.default_rng(0).integers(-32768, 32767, (B, L)).astype(np.int16)
    ref = np.asarray(pl.pallas_call(
        script_kern, out_shape=jax.ShapeDtypeStruct((B, B), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)(jnp.asarray(x)))
    tx = torch.from_numpy(x)
    got = int16_gram_plain(tx)
    xf = tx.float() / 32768
    _assert_within(got, ref, matmul_bound(xf, xf.t()), "int16 gram")


@pytest.mark.parametrize("dt,tdt", [(jnp.int16, torch.int16), (jnp.float32, torch.float32)],
                         ids=["int16", "f32"])
def test_wave_sums_plain_matches_script_kern2(dt, tdt):
    """One sum per wave block, on integers in [-4, 4) (the script's zeros
    would show nothing): exact on both sides.  Column 1, which the script
    never writes (NaN in interpret mode), is not compared."""
    n, rows, L = 4, 8, 128
    x = np.random.default_rng(1).integers(-4, 4, (n, rows, L))
    ref = np.asarray(pl.pallas_call(
        script_kern2, grid=(n,),
        out_shape=jax.ShapeDtypeStruct((n, 2), jnp.float32),
        in_specs=[pl.BlockSpec((1, rows, L), lambda c: (c, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        compiler_params=pltpu.CompilerParams(dimension_semantics=("parallel",)),
        interpret=True)(jnp.asarray(x).astype(dt)))
    got = wave_block_sums_plain(torch.from_numpy(x).to(tdt))
    assert (ref[:, 0] != 0).any()
    np.testing.assert_array_equal(got[:, 0].numpy(), ref[:, 0])
    assert (got[:, 1] == 0).all()


# ---- P7: frame rows → chunk lane blocks ------------------------------------

def script_relayout_kernels(C, nb):
    """``probe_chunk_relayout.py:26`` (``k_pass``) and ``:29``
    (``k_reshape``), verbatim but for the sizes, which the script fixes at
    C 43 and nb = Nt·F/128 = 40."""
    def k_pass(x_ref, o_ref):
        o_ref[0] = x_ref[0] + 1.0

    def k_reshape(x_ref, o_ref):
        v = x_ref[0]                                  # [C·Nt, F]
        o_ref[0] = v.reshape(C, nb, 128) + 1.0
    return k_pass, k_reshape


@pytest.mark.parametrize("reshape", [False, True], ids=["k_pass", "k_reshape"])
def test_relayout_plain_matches_script_kernels(reshape):
    """x + 1 in f32: exact; the reshape's layout equal too."""
    B, C_, Nt, F_ = 2, 3, 4, 64
    nb = Nt * F_ // 128
    x = np.random.default_rng(2).standard_normal((B, C_ * Nt, F_)).astype(np.float32)
    oshape = (C_, nb, 128) if reshape else (C_ * Nt, F_)
    kern = script_relayout_kernels(C_, nb)[int(reshape)]
    ref = np.asarray(pl.pallas_call(
        kern, grid=(B,),
        in_specs=[pl.BlockSpec((1, C_ * Nt, F_), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1,) + oshape, lambda i: (i,) + (0,) * len(oshape),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((B,) + oshape, jnp.float32),
        interpret=True)(jnp.asarray(x)))
    got = chunk_relayout_plain(torch.from_numpy(x), C_, Nt, reshape)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


# ---- P8, P9: the DFT as a matmul, |·|² ------------------------------------

def _dft_inputs(seed=3):
    """The scripts' distributions at the small size: waves 0.1·N(0, 1)
    f32, w0 and w1 N(0, 1) → bf16."""
    rng = np.random.default_rng(seed)
    waves = (0.1 * rng.standard_normal((N_CLIPS, R * HOP))).astype(np.float32)
    w0 = rng.standard_normal((HOP, 2 * F)).astype(np.float32)
    w1 = rng.standard_normal((HOP, 2 * F)).astype(np.float32)
    x3 = waves.reshape(N_CLIPS, R, HOP)
    jx = (jnp.asarray(x3), jnp.asarray(w0, dtype=jnp.bfloat16),
          jnp.asarray(w1, dtype=jnp.bfloat16))
    tx = (torch.from_numpy(x3), torch.from_numpy(w0).bfloat16(),
          torch.from_numpy(w1).bfloat16())
    return jx, tx


def script_blockc_kernels(G, R, hop, F, C, Nt):
    """``probe_featurize_blockc.py:78`` (``k_unroll``) and ``:93``
    (``k_stack``), verbatim but for the sizes, which the script fixes at R
    431, hop 512, F 512, C 43, Nt 10."""
    def k_unroll(x_ref, w0_ref, w1_ref, out_ref, G=G):
        for g in range(G):
            x = x_ref[g].astype(jnp.bfloat16)
            reim = (jnp.dot(x[: R - 1], w0_ref[...],
                            preferred_element_type=jnp.float32)
                    + jnp.dot(x[1:], w1_ref[...],
                              preferred_element_type=jnp.float32))
            m2 = reim[:, :F] ** 2 + reim[:, F:] ** 2
            out_ref[g] = m2[: C * Nt].reshape(C, Nt, F
                                              ).astype(jnp.bfloat16)

    def k_stack(x_ref, w0_ref, w1_ref, out_ref, G=G):
        xs = x_ref[...].reshape(G * R, hop).astype(jnp.bfloat16)
        reim = (jnp.dot(xs[: G * R - 1], w0_ref[...],
                        preferred_element_type=jnp.float32)
                + jnp.dot(xs[1:], w1_ref[...],
                          preferred_element_type=jnp.float32))
        m2 = reim[:, :F] ** 2 + reim[:, F:] ** 2  # [G·R−1, F]
        for g in range(G):
            out_ref[g] = m2[g * R: g * R + C * Nt].reshape(
                C, Nt, F).astype(jnp.bfloat16)

    return k_unroll, k_stack


def _blockc_call(kern, G):
    """The script's ``make(kern, G)``, in interpret mode."""
    return pl.pallas_call(
        kern, grid=(N_CLIPS // G,),
        in_specs=[pl.BlockSpec((G, R, HOP), lambda c: (c, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((G, C, NT, F), lambda c: (c, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((N_CLIPS, C, NT, F), jnp.bfloat16),
        compiler_params=pltpu.CompilerParams(dimension_semantics=("parallel",)),
        interpret=True)


def _hold_dft(ref, tx, mode="direct", s0=None, what=""):
    """The port's plain version against the script's output on the rows the
    variant writes, within dft_mag2_bound; returns the plain output."""
    got = dft_mag2_plain(*tx, C, NT, mode, s0)
    written = dft_written(tx[0], C, NT, mode, s0)[..., None].numpy()
    ref = np.where(written, np.asarray(ref, np.float32), 0.0)
    bound = dft_mag2_bound(*tx, C, NT, mode, s0)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert np.isfinite(ref).all() and (ref != 0).any()
    _assert_within(got.float(), ref, bound, what)
    # the bound is rounding, not the size of the output
    rel = bound.numpy()[ref != 0] / np.abs(ref[ref != 0])
    assert np.median(rel) < 0.02
    return got


@pytest.mark.parametrize("G,stacked", p8.FORMS, ids=lambda v: str(v))
def test_dft_plain_matches_script_blockc(G, stacked):
    """P8: f32 sums of exact bf16 products in another order, carried
    through re² + im², and one bf16 rounding a side: within
    dft_mag2_bound.  Stacked or not, G clips a step compute the same
    function (the stacked seam frames are not written)."""
    jx, tx = _dft_inputs()
    kern = script_blockc_kernels(G, R, HOP, F, C, NT)[int(stacked)]
    ref = _blockc_call(kern, G)(*jx)
    _hold_dft(ref, tx, what=f"G={G} stacked={stacked}")


def script_variant_kernels(R, F, C, Nt):
    """``profile_featurize_variants.py:77`` (``k_matmul``), ``:90``
    (``k_matmul_f``), ``:103`` (``k_scratch``), ``:120`` (``k_full``) and
    ``:143`` (``k_nozero``), verbatim but for the sizes, which the script
    fixes at R 431, F 512, C 43, Nt 10."""
    # v0: matmul + square only, direct static write to out
    def k_matmul(s_ref, x_ref, w0_ref, w1_ref, out_ref):
        x = x_ref[0].astype(jnp.bfloat16)
        reim = (jnp.dot(x[: R - 1], w0_ref[...],
                        preferred_element_type=jnp.float32)
                + jnp.dot(x[1:], w1_ref[...],
                          preferred_element_type=jnp.float32))
        m2 = reim[:, :F] ** 2 + reim[:, F:] ** 2
        out_ref[0] = m2[: C * Nt].reshape(C, Nt, F).astype(jnp.bfloat16)

    # v0f: same but f32 input conversion in kernel
    def k_matmul_f(s_ref, x_ref, w0_ref, w1_ref, out_ref):
        x = x_ref[0].astype(jnp.float32).astype(jnp.bfloat16)
        reim = (jnp.dot(x[: R - 1], w0_ref[...],
                        preferred_element_type=jnp.float32)
                + jnp.dot(x[1:], w1_ref[...],
                          preferred_element_type=jnp.float32))
        m2 = reim[:, :F] ** 2 + reim[:, F:] ** 2
        out_ref[0] = m2[: C * Nt].reshape(C, Nt, F).astype(jnp.bfloat16)

    # v1: + scratch write + aligned read, NO switch (delta assumed 0)
    def k_scratch(s_ref, x_ref, w0_ref, w1_ref, out_ref, scratch):
        s0v = s_ref[pl.program_id(0)]
        x = x_ref[0].astype(jnp.bfloat16)
        reim = (jnp.dot(x[: R - 1], w0_ref[...],
                        preferred_element_type=jnp.float32)
                + jnp.dot(x[1:], w1_ref[...],
                          preferred_element_type=jnp.float32))
        m2 = reim[:, :F] ** 2 + reim[:, F:] ** 2
        scratch[8: 8 + R - 1, :] = m2
        u = 7 + s0v
        u_c = pl.multiple_of((u // 8) * 8, 8)
        window = scratch[pl.ds(u_c, C * Nt + 8), :]
        out_ref[0] = window[: C * Nt].reshape(C, Nt, F).astype(jnp.bfloat16)

    # v2: + full zero init + 8-way switch (the current kernel shape)
    def k_full(s_ref, x_ref, w0_ref, w1_ref, out_ref, scratch):
        s0v = s_ref[pl.program_id(0)]
        x = x_ref[0].astype(jnp.bfloat16)
        reim = (jnp.dot(x[: R - 1], w0_ref[...],
                        preferred_element_type=jnp.float32)
                + jnp.dot(x[1:], w1_ref[...],
                          preferred_element_type=jnp.float32))
        m2 = reim[:, :F] ** 2 + reim[:, F:] ** 2
        scratch[...] = jnp.zeros(scratch.shape, scratch.dtype)
        scratch[8: 8 + R - 1, :] = m2
        u = 7 + s0v
        u_c = pl.multiple_of((u // 8) * 8, 8)
        delta = u - u_c
        window = scratch[pl.ds(u_c, C * Nt + 8), :]
        frames = jax.lax.switch(
            delta,
            [lambda w=window, d=d: w[d: d + C * Nt] for d in range(8)])
        out_ref[0] = frames.reshape(C, Nt, F).astype(jnp.bfloat16)

    # v3: switch replaced by weighted add of two shifted windows? try
    # dynamic lane... skip; instead: switch over 8 but with no zero init
    def k_nozero(s_ref, x_ref, w0_ref, w1_ref, out_ref, scratch):
        s0v = s_ref[pl.program_id(0)]
        x = x_ref[0].astype(jnp.bfloat16)
        reim = (jnp.dot(x[: R - 1], w0_ref[...],
                        preferred_element_type=jnp.float32)
                + jnp.dot(x[1:], w1_ref[...],
                          preferred_element_type=jnp.float32))
        m2 = reim[:, :F] ** 2 + reim[:, F:] ** 2
        scratch[8: 8 + R - 1, :] = m2
        u = 7 + s0v
        u_c = pl.multiple_of((u // 8) * 8, 8)
        delta = u - u_c
        window = scratch[pl.ds(u_c, C * Nt + 8), :]
        frames = jax.lax.switch(
            delta,
            [lambda w=window, d=d: w[d: d + C * Nt] for d in range(8)])
        out_ref[0] = frames.reshape(C, Nt, F).astype(jnp.bfloat16)

    return {"k_matmul": (k_matmul, False), "k_matmul_f": (k_matmul_f, False),
            "k_scratch": (k_scratch, True), "k_full": (k_full, True),
            "k_nozero": (k_nozero, True)}


def _variant_call(kern, scratch):
    """The script's ``make(kern, scratch)`` (block_c 1), in interpret mode."""
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(N_CLIPS,),
        in_specs=[pl.BlockSpec((1, R, HOP), lambda c, s: (c, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, C, NT, F), lambda c, s: (c, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=([pltpu.VMEM((R + C * NT + 24, F), jnp.float32)] if scratch else []))
    return pl.pallas_call(
        kern, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((N_CLIPS, C, NT, F), jnp.bfloat16),
        compiler_params=pltpu.CompilerParams(dimension_semantics=("arbitrary",)),
        interpret=True)


# trim starts with every 8-aligned window case the small scratch holds: 0
# (the aligned read starts 8 rows early), 1, both sides of each multiple of 8
S0 = np.array([0, 1, 5, 7, 8, 9, 15, 16], np.int32)
VARIANT_MODES = {"k_matmul": "direct", "k_matmul_f": "direct", "k_scratch": "aligned",
                 "k_full": "shift", "k_nozero": "shift_nozero"}


@pytest.mark.parametrize("name", list(VARIANT_MODES))
def test_dft_plain_matches_script_variants(name):
    """P9: the same bound as P8, on the rows the variant defines: every row
    for k_matmul, k_matmul_f and k_full (whose rows without a source frame
    are zero on both sides), and for k_scratch and k_nozero only the rows
    with a source frame (the others hold whatever the scratch held)."""
    jx, tx = _dft_inputs()
    kern, scratch = script_variant_kernels(R, F, C, NT)[name]
    ref = _variant_call(kern, scratch)(jnp.asarray(S0), *jx)
    mode = VARIANT_MODES[name]
    s0 = torch.from_numpy(S0)
    got = _hold_dft(ref, tx, mode, s0, what=name)
    written = dft_written(tx[0], C, NT, mode, s0)
    if mode == "shift":
        # the zero fill: the rows without a source frame are 0 in the script
        src = torch.arange(C * NT) + s0.long()[:, None] - 1
        none = ((src < 0) | (src > R - 2)).reshape(N_CLIPS, C, NT)
        assert none.any() and (np.asarray(ref, np.float32)[none.numpy()] == 0).all()
        assert (got[none] == 0).all()
    if mode in ("aligned", "shift_nozero"):
        assert not written.all()


def test_dft_rows_follow_the_scripts_shift():
    """The source frame of each written row, against the scripts'
    arithmetic: k_full / k_nozero read scratch row 7 + s0 + j, which holds
    frame s0 − 1 + j; k_scratch reads row u_c + j, u_c = 8·⌊(7 + s0)/8⌋,
    which holds frame u_c − 8 + j (scratch row 8 + k holds frame k)."""
    x3 = torch.zeros(len(S0), R, HOP)
    s0 = torch.from_numpy(S0)
    for mode, first_src in (("shift_nozero", lambda s: s - 1),
                            ("aligned", lambda s: (7 + s) // 8 * 8 - 8)):
        written = dft_written(x3, C, NT, mode, s0).reshape(len(S0), -1)
        for b, s in enumerate(S0.tolist()):
            src = first_src(s) + np.arange(C * NT)
            np.testing.assert_array_equal(written[b].numpy(), (src >= 0) & (src <= R - 2))


def test_dft_bound_catches_shifted_rows_and_seam_frames():
    """The check can fail: rows one frame off, or a clip-seam frame (clip
    0's last frame with clip 1's first) in clip 1's row 0, lie outside the
    bound; the stacked form's tile account follows the script's rows."""
    _, tx = _dft_inputs()
    ref = dft_mag2_plain(*tx, C, NT).float()
    bound = dft_mag2_bound(*tx, C, NT)
    off = dft_mag2_plain(*tx, C, NT, "shift", torch.full((N_CLIPS,), 2, dtype=torch.int32))
    assert ((off.float() - ref).abs() > bound).any()
    x3 = tx[0]
    seam = dft_mag2_plain(x3[:2].reshape(1, 2 * R, HOP), *tx[1:], C, NT, "shift",
                          torch.tensor([R], dtype=torch.int32))
    assert ((seam[0, 0, 0].float() - ref[1, 0, 0]).abs() > bound[1, 0, 0]).any()
    assert dft_rows_per_block(431, 1, False) == (4, 512, 430)
    assert dft_rows_per_block(431, 8, True) == (27, 3456, 3440)


# ---- the wrappers and the probes without a card ----------------------------

def test_featurize_probe_wrappers_send_cpu_tensors_to_plain_versions():
    kernels = (int16_gram, wave_block_sums, chunk_relayout, dft_mag2)
    counts = [f.launches for f in kernels]
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-32768, 32767, (8, 40), generator=g, dtype=torch.int16)
    assert torch.equal(int16_gram(x), int16_gram_plain(x))
    w = torch.randint(-4, 4, (3, 4, 8), generator=g, dtype=torch.int16)
    assert torch.equal(wave_block_sums(w), wave_block_sums_plain(w))
    xr = torch.randn(2, 12, 32, generator=g)
    for rs in (False, True):
        assert torch.equal(chunk_relayout(xr, 3, 4, rs), chunk_relayout_plain(xr, 3, 4, rs))
    _, tx = _dft_inputs()
    s0 = torch.from_numpy(S0)
    for mode in ("direct", "shift", "shift_nozero", "aligned"):
        assert torch.equal(dft_mag2(*tx, C, NT, mode, s0, G=2),
                           dft_mag2_plain(*tx, C, NT, mode, s0))
    assert [f.launches for f in kernels] == counts


def test_probe_registry_knows_the_k3_family():
    """Nine probes; each new one names the scripts' kernel lines it ports,
    and each named line is the script's ``def`` of that kernel."""
    assert {"int16_load", "chunk_relayout", "featurize_blockc",
            "featurize_variants"} <= set(PROBES) and len(PROBES) == 9
    lines = list(p6.REPLACES.values()) + list(p7.REPLACES.values()) + list(
        p8.REPLACES.values()) + [rep for _, rep in p9.VARIANTS.values()]
    assert len(set(lines)) == 11
    for ref in lines:
        path, line = ref.split(":")
        text = open(os.path.join(REPO, path)).read().splitlines()[int(line) - 1]
        assert re.match(r"\s*def k\w*\(", text), (ref, text)
