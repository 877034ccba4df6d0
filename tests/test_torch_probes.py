"""The probe kernels' plain versions (``pcaudio_torch.ops.kernels.probes``) ==
the TPU probe scripts' Pallas kernels run in interpret mode on the CPU, at
small sizes, from the same numpy inputs.

P1 (``scripts/probe_batched_dot.py::kernel``) and P4a
(``scripts/probe_lane_width.py::chain_kernel``) are the scripts' own
module-level functions.  P2, P3 and P4b are closures inside the scripts'
``main()``; their bodies are copied below verbatim, with the sizes the
scripts fix (1024 rows, 512 or 128 columns, 8 pairs of 128 keys) made
arguments.  The CUDA kernels themselves are held against the same plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import functools
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from pcaudio.bench.flops_calc import st_flops as jax_st_flops
from pcaudio_torch.ops.kernels.probes import (
    attend_bound, exp_chain_bound, matmul_bound, probe_attend,
    probe_attend_plain, probe_chain, probe_chain_plain, probe_exp_chain,
    probe_exp_chain_plain, probe_matmul, probe_matmul_plain, quant,
    signed_permutation)
from pcaudio_torch.probes import PROBES
from pcaudio_torch.probes import timing
from pcaudio_torch.probes.st_launch import st_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    """``scripts/probe_<name>.py`` as a module (its ``main`` is not run)."""
    path = os.path.join(REPO, "scripts", f"probe_{name}.py")
    spec = importlib.util.spec_from_file_location(f"_script_probe_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret(kernel, out_shape, dtype, *args, grid=None):
    kw = {} if grid is None else {"grid": grid}
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, dtype),
        interpret=True, **kw)(*args))


def _assert_within(got, ref, bound, what):
    """|got − ref| ≤ bound elementwise (equal infinities count as equal)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    with np.errstate(invalid="ignore"):
        err = np.where(got == ref, 0.0, np.abs(got - ref))
    bound = np.broadcast_to(np.asarray(bound, np.float64), err.shape)
    assert (err <= bound).all(), (
        f"{what}: max |err| {np.nanmax(err):.3e} at bound "
        f"{bound.flat[int(np.nanargmax(err - bound))]:.3e}")


# ---- P1: the batched dot ---------------------------------------------------

def test_batched_dot_plain_matches_script_kernel():
    """bf16 operands, f32 sums on both sides: within matmul_bound
    (2·(K + 1)·2^-24·Σ|a||b|)."""
    mod = _script("batched_dot")
    rng = np.random.default_rng(0)
    B, M, K, N = 2, 16, 32, 8
    a = rng.standard_normal((B, M, K)).astype(np.float32)
    b = rng.standard_normal((B, K, N)).astype(np.float32)
    ref = _interpret(mod.kernel, (B, M, N), jnp.float32,
                     jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    got = probe_matmul_plain(ta, tb)
    assert got.shape == (B, M, N) and got.dtype == torch.float32
    _assert_within(got, ref, matmul_bound(ta, tb), "batched dot")


# ---- P2: int8 and bf16 windowed products ----------------------------------

def script_small_kernel(a_ref, b_ref, o_ref):
    """``probe_int8_matmul.py:21`` (``kern``), verbatim."""
    o_ref[...] = jax.lax.dot_general(
        a_ref[...], b_ref[...],
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)


def script_window_kernel(acc, reps, rows, cols):
    """``probe_int8_matmul.py:44`` (``make_big``) and ``:85`` (``make``),
    verbatim but for the sizes: the scripts fix rows 1024 and cols 512 or
    128."""
    def k3(a_ref, b_ref, o_ref):
        acc_v = jnp.zeros((rows, cols), acc)
        b = b_ref[...]
        for i in range(reps):
            a = a_ref[8 * i: 8 * i + rows]
            acc_v = acc_v + jax.lax.dot_general(
                a, b, dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=acc)
        o_ref[...] = acc_v.astype(jnp.float32)
    return k3


def test_int8_small_plain_matches_script_kernel():
    """int8 in [-127, 127) → int32: exact."""
    rng = np.random.default_rng(0)
    A = rng.integers(-127, 127, (32, 64)).astype(np.int8)
    B = rng.integers(-127, 127, (64, 16)).astype(np.int8)
    ref = _interpret(script_small_kernel, (32, 16), jnp.int32,
                     jnp.asarray(A), jnp.asarray(B))
    got = probe_matmul_plain(torch.from_numpy(A), torch.from_numpy(B))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dt,acc", [(jnp.int8, jnp.int32),
                                    (jnp.bfloat16, jnp.float32)],
                         ids=["int8", "bf16"])
@pytest.mark.parametrize("reps", [4, 16])
def test_window_plain_matches_script_kernel(dt, acc, reps):
    """The scripts' integer operands in [-4, 4): every sum is an integer
    below 2^24, so int8 → int32 and bf16 → f32 are both exact.  The script
    overwrites its output each grid step (one step's product); the port's
    ``repeats`` sums the steps."""
    rng = np.random.default_rng(1)
    rows, K, cols, grid = 32, 64, 16, 3
    a = rng.integers(-4, 4, (rows + 8 * reps, K))
    b = rng.integers(-4, 4, (K, cols))
    ref = _interpret(script_window_kernel(acc, reps, rows, cols), (rows, cols),
                     jnp.float32, jnp.asarray(a).astype(dt),
                     jnp.asarray(b).astype(dt), grid=(grid,))
    tdt = torch.int8 if dt == jnp.int8 else torch.bfloat16
    ta = torch.from_numpy(a[: rows + 8 * (reps - 1)]).to(tdt)
    tb = torch.from_numpy(b).to(tdt)
    got = probe_matmul_plain(ta, tb, reps=reps, shift=8)
    np.testing.assert_array_equal(got.numpy().astype(np.float32), ref)
    summed = probe_matmul_plain(ta, tb, reps=reps, shift=8, repeats=grid)
    np.testing.assert_array_equal(summed.numpy().astype(np.float32), grid * ref)


# ---- P4: the 64- vs 128-wide chains ---------------------------------------

def script_vpu_kernel(x_ref, o_ref, *, reps):
    """``probe_lane_width.py:65`` (``vpu_kernel``), verbatim."""
    x = x_ref[...]
    for _ in range(reps):
        x = jnp.exp(x * 0.5)
    o_ref[...] = x


@pytest.mark.parametrize("d", [8, 16])
def test_chain_plain_matches_script_kernel(d):
    """x ← bf16(x·w) 64 times at a signed permutation w: every product is
    exact on both sides, so they are equal and x keeps its values (at the
    script's w = N(0, 1)/d the chain decays to 0, where equality would
    show nothing)."""
    mod = _script("lane_width")
    rng = np.random.default_rng(0)
    n, reps = 16, 64
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = signed_permutation(d, torch.Generator().manual_seed(0)).float().numpy()
    ref = _interpret(functools.partial(mod.chain_kernel, reps=reps), (n, d),
                     jnp.bfloat16, jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(w, jnp.bfloat16), grid=(2,))
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = probe_chain_plain(tx, tw, reps)
    ref = ref.astype(np.float32)
    assert (ref != 0).all()
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not np.array_equal(ref, tx.float().numpy())  # w moved x


@pytest.mark.parametrize("d", [64, 128])
def test_signed_permutation_tells_step_counts_apart(d):
    """The chain's check input at the probe's widths: a signed permutation
    (one ±1 a row and a column) whose powers 0..128 all differ from its
    64th, so a chain kernel that skips or repeats steps cannot match."""
    w = signed_permutation(d, torch.Generator().manual_seed(0)).double()
    assert torch.equal(w.abs().sum(0), torch.ones(d, dtype=torch.float64))
    assert torch.equal(w.abs().sum(1), torch.ones(d, dtype=torch.float64))
    powers = [torch.eye(d, dtype=torch.float64)]
    for _ in range(128):
        powers.append(powers[-1] @ w)
    assert all(not torch.equal(p, powers[64]) for j, p in enumerate(powers) if j != 64)


@pytest.mark.parametrize("reps", [1, 2])
def test_exp_chain_plain_matches_script_kernel(reps):
    """x ← exp(0.5·x): within exp_chain_bound (1e-3 relative; a few ulps of
    exp per step).  N(0, 1) inputs stay finite for two steps; after three
    both sides are +inf, where the comparison would show nothing."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    ref = _interpret(functools.partial(script_vpu_kernel, reps=reps), x.shape,
                     jnp.float32, jnp.asarray(x), grid=(2,))
    got = probe_exp_chain_plain(torch.from_numpy(x), reps)
    assert np.isfinite(ref).all()
    _assert_within(got, ref, exp_chain_bound(got), "exp chain")


# ---- P3: the v6 attend in bf16 and int8 -----------------------------------

def script_attend_kernel(mode, P, K, rows0, dv2):
    """``probe_int8_attend.py:47`` (``quant``) and ``:53``
    (``make_kernel``), verbatim but for the sizes, which the script fixes at
    P 8, K 128, rows0 1024, dv2 128."""
    def quant(x):
        """f32 [n, d] → (int8 values, f32 scale scalar)."""
        s = jnp.max(jnp.abs(x)) * (1.0 / 127.0) + 1e-30
        xq = jnp.round(x * (1.0 / s)).astype(jnp.int8)
        return xq, s

    def kern(iq_ref, k_ref, o_ref):
        g = pl.program_id(0)
        acc = jnp.zeros((rows0, dv2), jnp.float32)
        if mode == "int8":
            iq8, s_q = quant(iq_ref[...])   # loop-invariant (hoistable)
        else:
            iqb = iq_ref[...].astype(jnp.bfloat16)
        for p in range(P):
            off = (g % P) * K + p * K
            k_p = k_ref[pl.ds(off, K), :]
            if mode == "int8":
                k8, s_k = quant(k_p)
                lg = jax.lax.dot_general(
                    iq8, k8,
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.int32
                ).astype(jnp.float32) * (s_q * s_k * 0.125)
                pexp = jnp.exp(jnp.clip(lg, -50.0, 50.0))
                a = pexp / jnp.sum(pexp, axis=-1, keepdims=True)
                a8 = jnp.round(a * 127.0).astype(jnp.int8)
                av = jax.lax.dot_general(
                    a8, k8,
                    dimension_numbers=(((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32
                ).astype(jnp.float32) * (s_k / 127.0)
            else:
                kb = k_p.astype(jnp.bfloat16)
                lg = jax.lax.dot_general(
                    iqb, kb,
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32) * 0.125
                pexp = jnp.exp(jnp.clip(lg, -50.0, 50.0))
                a = pexp / jnp.sum(pexp, axis=-1, keepdims=True)
                av = jnp.dot(a.astype(jnp.bfloat16), kb,
                             preferred_element_type=jnp.float32)
            acc = acc + av

        @pl.when(g == 0)
        def _():
            o_ref[...] = jnp.zeros_like(o_ref)

        o_ref[...] += acc   # keep every grid step's work live (no DCE)
    return kern


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_attend_plain_matches_script_kernel(mode):
    """rows 32, dv 16, 2 pairs of 16 keys, 4 grid steps, the script's
    N(0, 1.5) queries and N(0, 1.2) keys.  Within attend_bound: f32 sums
    (steps·pairs + keys)·2^-24·Σ|a||k| apart, plus, where the logits' or
    exp's last-ulp difference can reach a rounding midpoint of bf16(a) or
    of a8 = round(a·127), that one rounding step (one a8 step moves av by
    |k8|·s_k/127).  Quantisation is bit-identical on both sides."""
    P, K, rows, dv, grid = 2, 16, 32, 16, 4
    rng = np.random.default_rng(0)
    iq = rng.normal(0, 1.5, (rows, dv)).astype(np.float32)
    kmat = rng.normal(0, 1.2, (2 * P * K, dv)).astype(np.float32)
    ref = _interpret(script_attend_kernel(mode, P, K, rows, dv), (rows, dv),
                     jnp.float32, jnp.asarray(iq), jnp.asarray(kmat),
                     grid=(grid,))
    tq, tk = torch.from_numpy(iq), torch.from_numpy(kmat)
    got = probe_attend_plain(tq, tk, mode, pairs=P, keys=K, steps=grid)
    bound = attend_bound(tq, tk, mode, pairs=P, keys=K, steps=grid)
    _assert_within(got, ref, bound, mode)
    # the bound is a few rounding steps, not the size of the output
    assert float(bound.max()) < 0.05 * np.abs(ref).max()


def test_round_half_even_on_both_sides():
    """jnp.round and torch.round both round halves to even (CUDA's roundf
    rounds them away from zero, so the attend kernel uses __float2int_rn,
    round to nearest even)."""
    x = np.array([-127.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5], np.float32)
    even = np.array([-128, -2, -2, 0, 0, 2, 2, 126], np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.round(jnp.asarray(x))), even)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(), even)
    # quant's ties: 0.5·s and 1.5·s land exactly on .5 after the scaling
    q, s = quant(torch.tensor([127.0, 0.5, 1.5, -2.5]))
    assert float(s) == np.float32(127.0) * np.float32(1 / 127.0) + np.float32(1e-30)
    np.testing.assert_array_equal(q.numpy(), np.round(
        np.array([127.0, 0.5, 1.5, -2.5], np.float32) * np.float32(1 / float(s))))
    src = open(os.path.join(REPO, "pcaudio_torch", "csrc", "probe_attend.cu")).read()
    assert "__float2int_rn" in src and not re.search(r"\broundf?\(", src)


# ---- the wrappers and the probes without a card ----------------------------

def test_probe_wrappers_send_cpu_tensors_to_plain_versions():
    kernels = (probe_matmul, probe_chain, probe_exp_chain, probe_attend)
    counts = [f.launches for f in kernels]
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-4, 4, (24, 32), generator=g).to(torch.int8)
    b = torch.randint(-4, 4, (32, 16), generator=g).to(torch.int8)
    assert torch.equal(probe_matmul(a, b, 3, 8, 2), probe_matmul_plain(a, b, 3, 8, 2))
    x = torch.randn(16, 8, generator=g).bfloat16()
    w = (torch.randn(8, 8, generator=g) / 8).bfloat16()
    assert torch.equal(probe_chain(x, w, 5, 2), probe_chain_plain(x, w, 5, 2))
    xf = torch.randn(4, 8, generator=g)
    assert torch.equal(probe_exp_chain(xf, 3, 2), probe_exp_chain_plain(xf, 3, 2))
    iq, km = torch.randn(8, 16, generator=g), torch.randn(64, 16, generator=g)
    for mode in ("bf16", "int8"):
        assert torch.equal(probe_attend(iq, km, mode, 2, 16, 3),
                           probe_attend_plain(iq, km, mode, 2, 16, 3))
    assert [f.launches for f in kernels] == counts


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probes_default_to_the_card_and_raise_without_one(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PROBES[name].run()
    with pytest.raises(RuntimeError, match="not a CUDA device"):
        PROBES[name].run("cpu", 0)


def test_timing_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        timing.cuda_ms(lambda: None, 1)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        timing.paired_ms(lambda: None, lambda: None, 1, 1)


def test_bound_ms_takes_the_slower_of_bytes_and_operations():
    assert timing.bound_ms({"bf16": 989e12}, 1.0) == (1000.0, "operations")
    assert timing.bound_ms({"int8": 1979e9, "sfu": 1.0}, 3.35e12) == (1000.0, "bytes")
    assert timing.bound_ms({"bf16": 989e9, "int8": 1979e12}, 0.0)[0] == 1000.0


def test_st_flops_matches_the_jax_package():
    """P5's bound counts K1's work as ``pcaudio/bench/flops_calc.py`` does:
    20.1 MFLOP a 3ST cloud of 128 points."""
    for args in ((128, 3, 64, 64, 10), (128, 2, 64, 64, 10), (40, 3, 16, 8, 10)):
        assert st_flops(*args) == jax_st_flops(*args)
    assert st_flops(128, 3, 64, 64, 10) == pytest.approx(20.1e6, rel=1e-2)
