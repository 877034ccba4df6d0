"""The port's model zoo (``pcaudio_torch.nn``) against the reference modules'
outputs in ``tests/golden/*.npz`` (state dict, input, output; atol = rtol =
2e-5, the bar of tests/test_golden_parity.py) and against the JAX modules
with the same weights, carried by the ``*_state_dict_from_jax`` functions;
and the dropout that the baselines train through.

JAX draws its init from ``jax.random``; inputs come from numpy seeds.  The
JAX MAB's LayerNorm takes flax's ε 1e-6 where torch's (and the reference's,
so the goldens') is 1e-5: with ``ln=True`` the port is held to the golden at
2e-5, to the JAX module at 2e-5 once the port's ε is set to 1e-6, and
within 1e-4 of the JAX module as it stands (the gap is about ε / (2·var)
of each row's scale)."""
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pcaudio import checkpoint as jax_ckpt
from pcaudio.checkpoint.torch_export import (
    baseline_ff_state_dict, cnn_classifier_state_dict)
from pcaudio.nn import MAB as JaxMAB
from pcaudio.nn import BaselineFF as JaxBaselineFF
from pcaudio.nn import CNNClassifier as JaxCNN
from pcaudio.nn import DeepSet as JaxDeepSet
from pcaudio.nn import SetTransformer as JaxSetTransformer
from pcaudio_torch.checkpoint import (
    _mab, baseline_ff_state_dict_from_jax, cnn_classifier_state_dict_from_jax,
    deepset_state_dict_from_jax, set_transformer_state_dict_from_jax)
from pcaudio_torch.nn import (
    ISAB, MAB, PMA, SAB, BaselineFF, CNNClassifier, DeepSet, Dropout,
    SetTransformer)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOL = dict(atol=2e-5, rtol=2e-5)
JAX_TOL = dict(atol=1e-5, rtol=1e-5)  # f32 on both sides, other sum orders

GOLDEN_CASES = {  # name: (the port module, the input names in call order)
    "baseline_ff": (lambda: BaselineFF((1025, 513, 256), nclasses=10), ("x",)),
    "cnn_temp": (lambda: CNNClassifier(10, 512, (512, 256, 100), nclass=10),
                 ("x",)),
    "deepset": (lambda: DeepSet(3, 2, 5, dim_hidden=16), ("X",)),
    "set_transformer": (lambda: SetTransformer(3, 2, 5, num_inds=8,
                                               dim_hidden=16, num_heads=4),
                        ("X",)),
    "mab_ln0": (lambda: MAB(5, 7, 8, 2), ("Q", "K")),
    "mab_ln1": (lambda: MAB(5, 7, 8, 2, ln=True), ("Q", "K")),
    "sab": (lambda: SAB(6, 8, 4), ("X",)),
    "isab": (lambda: ISAB(3, 8, 2, 5), ("X",)),
    "pma": (lambda: PMA(8, 2, 3), ("X",)),
}


def _golden(name):
    z = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")}
    inputs = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("in.")}
    return sd, inputs, z["out"]


@pytest.mark.parametrize("name", list(GOLDEN_CASES))
def test_matches_golden(name):
    """The reference's state dict loads by ``load_state_dict`` (strict: the
    names are the reference's) and the output is the reference's."""
    make, keys = GOLDEN_CASES[name]
    sd, inputs, ref = _golden(name)
    model = make()
    model.load_state_dict(sd)
    with torch.no_grad():
        out = model.eval()(*(inputs[k] for k in keys))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def _jax_init(module, *shapes, **kw):
    params = jax.jit(module.init)(jax.random.key(0),
                                  *(jnp.zeros(s) for s in shapes), **kw)
    return jax.tree_util.tree_map(np.asarray, params)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("apply_softmax", [True, False])
def test_baseline_ff_matches_jax(apply_softmax):
    """The JAX module with its trailing softmax against the port's output,
    and without it against the port's logits (``ENC_NN``)."""
    jm = JaxBaselineFF(layer_dims=(129, 64, 32), nclasses=10,
                       apply_softmax=apply_softmax)
    params = _jax_init(jm, (1, 129))
    tm = BaselineFF((129, 64, 32), nclasses=10)
    tm.load_state_dict(baseline_ff_state_dict_from_jax(params))
    x = 3.0 * _randn(1, 6, 129) - 8.0
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = (tm.eval() if apply_softmax else tm.ENC_NN)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, **JAX_TOL)


@pytest.mark.parametrize("layer_dims", [(128, 32, 16), (120, 40)],
                         ids=["kernel_10x1", "kernel_10x9"])
def test_cnn_classifier_matches_jax(layer_dims):
    jm = JaxCNN(Nt=10, Nf=128, layer_dims=layer_dims, nclass=10)
    params = _jax_init(jm, (1, 10, 128))
    tm = CNNClassifier(10, 128, layer_dims, nclass=10)
    tm.load_state_dict(cnn_classifier_state_dict_from_jax(params))
    x = 3.0 * _randn(2, 5, 10, 128) - 8.0
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **JAX_TOL)


@pytest.mark.parametrize("kw", [1, 9])
def test_cnn_convolution_is_conv2d(kw):
    """The convolution as a contraction of windows == ``F.conv2d`` of the
    same kernel (on the CPU, where no TF32 is involved)."""
    tm = CNNClassifier(10, 64, (65 - kw, 16), nclass=10)
    x = torch.from_numpy(_randn(3, 4, 10, 64))
    ref = F.conv2d(x[:, None], tm.cnn.weight, tm.cnn.bias)[:, 0, 0]
    with torch.no_grad():
        np.testing.assert_allclose(tm.conv(x).numpy(), ref.detach().numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_deepset_matches_jax(masked):
    jm = JaxDeepSet(dim_input=3, num_outputs=2, dim_output=5, dim_hidden=16)
    params = _jax_init(jm, (1, 8, 3))
    tm = DeepSet(3, 2, 5, dim_hidden=16)
    tm.load_state_dict(deepset_state_dict_from_jax(params))
    X = _randn(4, 4, 20, 3)
    mask = np.arange(20)[None, :] < np.array([20, 7, 1, 0])[:, None]
    ref = np.asarray(jax.jit(jm.apply)(
        params, jnp.asarray(X), mask=jnp.asarray(mask) if masked else None))
    with torch.no_grad():
        got = tm(torch.from_numpy(X),
                 torch.from_numpy(mask) if masked else None).numpy()
    np.testing.assert_allclose(got, ref, **JAX_TOL)


@pytest.mark.parametrize("ln,pointcloud", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_set_transformer_matches_jax(ln, pointcloud):
    """Both variants, with and without LayerNorms, on ragged masks (one
    sample fully masked), dropout off.  With ``ln`` the port's ε is set to
    flax's 1e-6 for this comparison (the module docstring)."""
    kw = dict(dim_input=3, num_outputs=1 if pointcloud else 2, dim_output=5,
              num_inds=8, dim_hidden=16, num_heads=4, ln=ln,
              pointcloud_variant=pointcloud)
    jm = JaxSetTransformer(**kw)
    params = _jax_init(jm, (1, 8, 3))
    tm = SetTransformer(**kw)
    tm.load_state_dict(set_transformer_state_dict_from_jax(params))
    for m in tm.modules():
        if isinstance(m, torch.nn.LayerNorm):
            m.eps = 1e-6
    X = _randn(5, 4, 24, 3)
    mask = np.arange(24)[None, :] < np.array([24, 13, 2, 0])[:, None]
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(X),
                                       mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(X), torch.from_numpy(mask)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **JAX_TOL)


@pytest.mark.parametrize("eps,tol", [(1e-6, 2e-5), (1e-5, 1e-4)],
                         ids=["flax_eps", "torch_eps"])
def test_mab_ln_matches_jax(eps, tol):
    """MAB(ln=True) against the JAX MAB: at flax's ε the same function; at
    torch's ε (the port's) within 1e-4."""
    jm = JaxMAB(dim_V=8, num_heads=2, ln=True)
    params = _jax_init(jm, (1, 11, 5), (1, 13, 7))
    tm = MAB(5, 7, 8, 2, ln=True)
    sd = {}
    _mab(params["params"], "mab", sd)
    tm.load_state_dict({k.removeprefix("mab."): v for k, v in sd.items()})
    assert tm.ln0.eps == 1e-5
    tm.ln0.eps = tm.ln1.eps = eps
    Q, K = _randn(6, 3, 11, 5), _randn(7, 3, 13, 7)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(Q), jnp.asarray(K)))
    with torch.no_grad():
        got = tm(torch.from_numpy(Q), torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)


def test_baseline_converters_match_torch_export():
    """The port's copies of the FB and CNN mappings name and lay out every
    tensor as the JAX package's exporter does."""
    for jm, shape, port_fn, ref_fn in (
            (JaxBaselineFF(layer_dims=(129, 64, 32)), (1, 129),
             baseline_ff_state_dict_from_jax, baseline_ff_state_dict),
            (JaxCNN(Nt=10, Nf=128, layer_dims=(128, 32, 16)), (1, 10, 128),
             cnn_classifier_state_dict_from_jax, cnn_classifier_state_dict)):
        params = _jax_init(jm, shape)
        got, ref = port_fn(params), ref_fn(params)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), ref[k])


@pytest.mark.parametrize("what", ["deepset", "set_transformer", "pointcloud_ln"])
def test_set_converters_invert_the_jax_importer(what):
    """A port state dict → the JAX importer's params → the port's converter
    gives back the same state dict, every name and value."""
    if what == "deepset":
        model = DeepSet(3, 2, 5, dim_hidden=16)
        to_jax = jax_ckpt.deepset_params
        back = deepset_state_dict_from_jax
    else:
        pc = what == "pointcloud_ln"
        model = SetTransformer(3, 1, 5, num_inds=8, dim_hidden=16, num_heads=4,
                               ln=pc, pointcloud_variant=pc)
        to_jax = lambda sd: jax_ckpt.set_transformer_params(  # noqa: E731
            sd, pointcloud_variant=pc)
        back = set_transformer_state_dict_from_jax
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    got = back(to_jax(sd))
    assert sorted(got) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k].numpy(), sd[k])


@pytest.mark.parametrize("p", [0.5, 0.2])
def test_dropout_keep_rate_and_scale(p):
    """Training mode keeps each element with probability 1 - p (within 5
    standard deviations over 400,000) and scales the kept by 1 / (1 - p),
    exactly; eval mode and p = 0 are the identity."""
    drop = Dropout(p)
    x = torch.ones(400_000)
    gen = torch.Generator().manual_seed(3)
    y = drop(x, gen)
    kept = y != 0
    rate = kept.double().mean().item()
    sd = (p * (1 - p) / x.numel()) ** 0.5
    assert abs(rate - (1 - p)) <= 5 * sd, rate
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / (1.0 - p)))
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(Dropout(0.0)(x), x)


def test_dropout_draws_from_its_generator_alone():
    """The same seed gives the same mask, another seed another; the global
    RNG is left as it was; training mode without a generator raises."""
    model = BaselineFF((64, 32), nclasses=10, p=0.5)
    x = torch.ones(16, 64)
    state = torch.get_rng_state()
    a = model(x, torch.Generator().manual_seed(7))
    b = model(x, torch.Generator().manual_seed(7))
    c = model(x, torch.Generator().manual_seed(8))
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        model(x)
    with torch.no_grad():
        assert torch.equal(model.eval()(x), model(x, torch.Generator()))
    with pytest.raises(ValueError, match="outside"):
        Dropout(1.0)
