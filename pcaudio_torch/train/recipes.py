"""The FST and 3ST training recipes as configs, data preparation and a
trainer builder (counterpart of ``pcaudio/train/recipes.py``).

The reference trains each model with a standalone script whose constants
are the configuration (``Code/settransformer.py:34-41,77-91``,
``Code/settransformertemp.py``).  The FB and CNNTemp recipes need models the
port does not have yet and raise.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pcaudio_torch.core.config import ARCH_3ST, ARCH_FST, ExperimentConfig
from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.dsp.featurize import (
    FeaturizeConfig, batched_temporal_chunks, featurize_batch)
from pcaudio_torch.ops.cloud import (
    frame_cloud, freq_coords, grid_cloud, time_coords)
from pcaudio_torch.train.glue import pointcloud_apply

CLIPS_PER_PASS = 64  # clips featurized together: bounds the STFT's memory


def fst_config() -> ExperimentConfig:
    """``Code/settransformer.py``: Nfft=2048, dh=64, heads=8, inds=64,
    bs=128, Adam(1e-3, wd=1e-3), 500 epochs."""
    return ExperimentConfig(architecture=ARCH_FST, window_size=2048,
                            dhidden=64, nheads=8, ninds=64, batch_size=128,
                            learning_rate=1e-3, weight_decay=1e-3, epochs=500,
                            numpy_seed=1, torch_seed=1)


def st3_config() -> ExperimentConfig:
    """``Code/settransformertemp.py``: Nfft=1024, Ntemp=10, bs=16."""
    return ExperimentConfig(architecture=ARCH_3ST, window_size=1024, Ntemp=10,
                            dhidden=64, nheads=8, ninds=64, batch_size=16,
                            learning_rate=1e-3, weight_decay=1e-3, epochs=500,
                            numpy_seed=1, torch_seed=1)


def _not_ported(name: str):
    def config() -> ExperimentConfig:
        raise NotImplementedError(f"the {name} recipe's model is not ported "
                                  f"yet (ROADMAP Queue 1)")
    return config


fb_config = _not_ported("FB")
cnn_temp_config = _not_ported("CNNTemp")

RECIPES = {"FST": fst_config, "FB": fb_config, "3ST": st3_config,
           "CNNTemp": cnn_temp_config}


def _featurized(waves, lengths, cfg: ExperimentConfig, device):
    """Yield ``(logmag [b, T, F], frame_mask [b, T], first clip)`` on
    ``device`` for groups of at most ``CLIPS_PER_PASS`` clips."""
    device = resolve_device(device)
    fcfg = FeaturizeConfig(fs=cfg.sampling_rate, n_fft=cfg.window_size,
                           hop_factor=cfg.hop_factor, top_db=cfg.trim_dB)
    waves, lengths = torch.as_tensor(waves), torch.as_tensor(lengths)
    for i in range(0, len(waves), CLIPS_PER_PASS):
        lm, fm = featurize_batch(waves[i: i + CLIPS_PER_PASS].to(device),
                                 lengths[i: i + CLIPS_PER_PASS].to(device),
                                 fcfg)
        yield lm, fm, i


def prepare_framewise_data(waves, lengths, labels, cfg: ExperimentConfig,
                           device="cuda") -> Dict[str, np.ndarray]:
    """Waveforms → FST training clouds ``points [Nf, bins, 2]``: all valid
    frames pooled over clips, each with its clip's label
    (``Code/settransformer.py:43-68``).  Featurized on ``device``; returned
    as host arrays."""
    labels = np.asarray(labels)
    xs, ls = [], []
    for lm, fm, i in _featurized(waves, lengths, cfg, device):
        B, T, bins = lm.shape
        valid = fm.reshape(B * T)
        frames = lm.reshape(B * T, bins)[valid]
        xs.append(frame_cloud(frames, freq_coords(
            bins, cfg.sampling_rate, device=frames.device)).cpu().numpy())
        ls.append(np.repeat(labels[i: i + B], T)[valid.cpu().numpy()])
    return {"points": np.concatenate(xs),
            "labels": np.concatenate(ls).astype(np.int32)}


def prepare_temporal_data(waves, lengths, labels, cfg: ExperimentConfig,
                          device="cuda") -> Dict[str, np.ndarray]:
    """Waveforms → 3ST training clouds ``points [Nc, Ntemp·(bins-1), 3]``:
    full ``Ntemp``-frame chunks pooled over clips
    (``Code/settransformertemp.py:50-59``).  Featurized on ``device``;
    returned as host arrays."""
    labels = np.asarray(labels)
    xs, ls = [], []
    for lm, fm, i in _featurized(waves, lengths, cfg, device):
        chunks, cmask = batched_temporal_chunks(lm, fm, cfg.Ntemp)
        B, C, Nt, bins = chunks.shape
        valid = cmask.reshape(B * C)
        flat = chunks.reshape(B * C, Nt, bins)[valid]
        dev = flat.device
        xs.append(grid_cloud(
            flat, freq_coords(bins, cfg.sampling_rate, device=dev),
            time_coords(Nt, cfg.window_size, cfg.sampling_rate,
                        cfg.hop_factor, device=dev)).cpu().numpy())
        ls.append(np.repeat(labels[i: i + B], C)[valid.cpu().numpy()])
    return {"points": np.concatenate(xs),
            "labels": np.concatenate(ls).astype(np.int32)}


def build_trainer(cfg: ExperimentConfig, device="cuda",
                  fused_attn: Optional[bool] = None) -> Tuple:
    """``(model, apply_fn, optimizer)`` for a recipe config, the model's
    weights drawn from ``cfg.torch_seed`` and placed on ``device`` (the
    card unless the caller names the CPU; no card raises).

    ``fused_attn`` routes the attention through kernel K4; ``None`` means
    the kernel on a CUDA device and the plain version on the CPU.  The
    optimizer is the reference's ``torch.optim.Adam(lr, weight_decay)``,
    which the JAX package's ``adam_l2`` emulates.
    """
    device = resolve_device(device)
    if fused_attn is None:
        fused_attn = device.type == "cuda"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.torch_seed)
        model = cfg.build_model(fused_attn=fused_attn)
    model = model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                                 weight_decay=cfg.weight_decay)
    return model, pointcloud_apply(model), optimizer
