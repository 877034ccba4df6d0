"""The slice as a whole: the port's temporal 3ST pipeline == the JAX one on
the same waves and weights.  The kernel path is held against the plain path
on the card in test_torch_cuda.py."""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcaudio.checkpoint import st_params
from pcaudio.eval.pipeline import TemporalPipelineConfig as JaxConfig
from pcaudio.eval.pipeline import extract_chunk_clouds as jax_extract
from pcaudio.eval.pipeline import make_temporal_classifier as jax_classifier
from pcaudio.nn import ST as JaxST
from pcaudio_torch.checkpoint import st_state_dict_from_jax
from pcaudio_torch.eval import (
    TemporalPipelineConfig, extract_chunk_clouds, make_chunk_logits,
    make_temporal_classifier)
from pcaudio_torch.nn import ST
from pcaudio_torch.ops.kernels.featurize import fused_chunk_mag2_plain
from pcaudio_torch.serve import AudioClassifier

TOP_K = 128


def _waves(B=2, L=65536, seed=0):
    rng = np.random.default_rng(seed)
    w = np.zeros((B, L), np.float32)
    lengths = np.array([60000, 42000][:B], np.int32)
    t = np.arange(L) / 44100.0
    for i, n in enumerate(lengths):
        tone = 0.3 * np.sin(2 * np.pi * (440.0 * (i + 1)) * t[:n])
        w[i, :n] = tone + 0.05 * rng.standard_normal(n)
    w[1, :3000] = 1e-6 * rng.standard_normal(3000)  # trimmed lead-in
    return w, lengths


def _models(dim=16, inds=8, heads=4, seed=0):
    tm = ST(dim_input=3, dim_output=10, num_inds=inds, dim_hidden=dim,
            num_heads=heads)
    rng = np.random.default_rng(seed)
    sd = {k: rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
          for k, v in tm.state_dict().items()}
    params = st_params(sd)
    tm.load_state_dict(st_state_dict_from_jax(params))
    jm = JaxST(dim_input=3, dim_output=10, num_inds=inds, dim_hidden=dim,
               num_heads=heads)
    return jm, params, tm.eval()


def _near_tie_chunks(waves, lengths, chunk_mask):
    """Valid chunks whose K-th and (K+1)-th |X|² lie within the featurize
    tolerance (1e-5·chunk max + 1e-4 relative): there a DFT-matmul grid
    (JAX) and an rfft grid (port) may order them differently."""
    m2, _ = fused_chunk_mag2_plain(torch.from_numpy(waves),
                                   torch.from_numpy(lengths),
                                   out_dtype=torch.float32)
    flat = m2.reshape(m2.shape[0], m2.shape[1], -1)
    top = torch.topk(flat, TOP_K + 1, dim=-1).values
    vk, vk1 = top[..., TOP_K - 1], top[..., TOP_K]
    gap_ok = (vk - vk1) <= 1e-5 * top[..., 0] + 1e-4 * vk
    return (gap_ok & torch.from_numpy(chunk_mask)).reshape(-1).numpy()


def test_slice_matches_jax_f32():
    """f32 configuration: same chunk masks, the same point set per valid
    chunk (within 1e-5 after a lexsort), clip logits within 1e-4."""
    waves, lengths = _waves()
    jm, params, tm = _models()
    jcfg = JaxConfig(fs=44100, n_fft=1024, num_frames=10, top_k=TOP_K,
                     featurize="fused", exact_kernel=True,
                     stft_precision="highest", compute_dtype="float32")
    cfg = TemporalPipelineConfig(fs=44100, n_fft=1024, num_frames=10,
                                 top_k=TOP_K, stft_precision="highest",
                                 compute_dtype="float32")
    jw, jl = jnp.asarray(waves), jnp.asarray(lengths)
    tw, tl = torch.from_numpy(waves), torch.from_numpy(lengths)

    jcloud, jcm = jax_extract(jw, jl, jcfg)
    cloud, cm = extract_chunk_clouds(tw, tl, cfg)
    jcm = np.array(jcm)
    np.testing.assert_array_equal(cm.numpy(), jcm)
    valid = jcm.reshape(-1)
    assert valid.sum() >= 12
    excusable = _near_tie_chunks(waves, lengths, jcm)
    ref_pts = np.asarray(jcloud.points)
    got_pts = cloud.points.numpy()
    mismatched = 0
    for c in np.nonzero(valid)[0]:
        a, b = ref_pts[c], got_pts[c]
        a, b = a[np.lexsort(a.T)], b[np.lexsort(b.T)]
        if not np.allclose(b, a, atol=1e-5, rtol=0):
            assert excusable[c], f"chunk {c}: point sets differ"
            mismatched += 1
    assert mismatched * 12 <= valid.sum()

    ref = np.asarray(jax_classifier(jm, jcfg, use_fused_st=False)(params, jw, jl))
    got = make_temporal_classifier(tm, cfg)(tw, tl).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    # the chunk-level view pools to the same clip logits
    chunk_logits, chunk_mask = make_chunk_logits(tm, cfg)(tw, tl)
    w = chunk_mask[..., None].float()
    pooled = (chunk_logits * w).sum(1) / w.sum(1).clamp_min(1.0)
    np.testing.assert_allclose(pooled.numpy(), got, atol=1e-6, rtol=0)


def test_slice_matches_jax_bf16_serving():
    """bf16 serving configuration vs JAX with its fused ST kernel
    (interpret): the JAX grid takes bf16 DFT operands and its ST bf16
    matmuls, the port computes both in f32, so near-tie winners can
    differ.  Argmax must agree except where JAX's top-2 gap is below twice
    the largest logit deviation, and |Δ| ≤ 5e-2 (docs/ACCURACY.md's bf16
    serving spread)."""
    waves, lengths = _waves(seed=1)
    jm, params, tm = _models(seed=1)
    jcfg = JaxConfig(fs=44100, n_fft=1024, num_frames=10, top_k=TOP_K,
                     featurize="fused", exact_kernel=True,
                     stft_precision="default", compute_dtype="bfloat16")
    cfg = TemporalPipelineConfig(fs=44100, n_fft=1024, num_frames=10,
                                 top_k=TOP_K, stft_precision="default",
                                 compute_dtype="bfloat16")
    ref = np.asarray(jax_classifier(jm, jcfg, use_fused_st=True)(
        params, jnp.asarray(waves), jnp.asarray(lengths)))
    got = make_temporal_classifier(tm, cfg, use_fused_st=True)(
        torch.from_numpy(waves), torch.from_numpy(lengths)).numpy()
    dev = np.abs(got - ref).max()
    assert dev <= 5e-2
    top2 = np.sort(ref, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) >= 2 * dev
    np.testing.assert_array_equal(got.argmax(-1)[decided],
                                  ref.argmax(-1)[decided])


def test_audio_classifier_full_width_ragged_request():
    torch.manual_seed(0)
    model = ST(dim_input=3, dim_output=10, num_inds=64, dim_hidden=64,
               num_heads=8)
    cfg = TemporalPipelineConfig(top_k=TOP_K, stft_precision="default",
                                 compute_dtype="bfloat16")
    clf = AudioClassifier(model=model, pipeline=cfg, batch_size=4,
                          buffer_len=32768, device="cpu")
    rng = np.random.default_rng(2)
    clips = [(0.1 * rng.standard_normal(n)).astype(np.float32)
             for n in (32768, 20000, 9000)]   # 3 clips, one padded slot
    lg = clf.logits(clips)
    assert lg.shape == (3, 10) and np.isfinite(lg).all()
    labels, probs = clf.classify(clips)
    np.testing.assert_array_equal(labels, lg.argmax(-1))
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


def test_from_reference_checkpoint(tmp_path):
    """A reference-convention 3ST config JSON + `module.`-prefixed .pth load
    into the served model; other architectures and n_fft are refused."""
    from pcaudio.core.config import ExperimentConfig as JaxExperimentConfig
    from pcaudio_torch.core import ExperimentConfig

    ref_cfg = {"architecture": "3ST (Set Transformer Temporal)",
               "window_size": 1024, "hop_factor": 0.5, "trim_dB": 60,
               "sampling_rate": 44100, "classes": 10, "dhidden": 16,
               "nheads": 4, "ninds": 8, "Ntemp": 10, "np_seed": 1}
    cfg_path = tmp_path / "3ST_config.json"
    cfg_path.write_text(json.dumps(ref_cfg))
    jcfg = JaxExperimentConfig.from_reference_json(str(cfg_path))
    tcfg = ExperimentConfig.from_reference_json(str(cfg_path))
    for f in ("architecture", "window_size", "hop_factor", "trim_dB",
              "sampling_rate", "classes", "dhidden", "nheads", "ninds",
              "Ntemp"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f

    _, _, tm = _models()
    pth = tmp_path / "3ST_net.pth"
    torch.save({f"module.{k}": v for k, v in tm.state_dict().items()}, pth)
    clf = AudioClassifier.from_reference_checkpoint(
        str(cfg_path), str(pth), top_k=64, batch_size=2, buffer_len=32768,
        device="cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(clf.model.state_dict()[k], v)
    assert clf.pipeline.n_fft == 1024 and clf.pipeline.top_k == 64
    clip = (0.1 * np.random.default_rng(0).standard_normal(30000)
            ).astype(np.float32)
    assert np.isfinite(clf.logits([clip])).all()

    fst = dict(ref_cfg, architecture="FST (Framewise Set Transformer)")
    (tmp_path / "fst.json").write_text(json.dumps(fst))
    with pytest.raises(ValueError, match="3ST"):
        AudioClassifier.from_reference_checkpoint(str(tmp_path / "fst.json"),
                                                  str(pth))
    wide = dict(ref_cfg, window_size=2048)
    (tmp_path / "wide.json").write_text(json.dumps(wide))
    clf = AudioClassifier.from_reference_checkpoint(
        str(tmp_path / "wide.json"), str(pth), batch_size=1,
        buffer_len=32768, device="cpu")
    with pytest.raises(ValueError, match="n_fft"):
        clf.logits([clip])
