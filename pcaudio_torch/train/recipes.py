"""The four training recipes as configs, data preparation and a trainer
builder (counterpart of ``pcaudio/train/recipes.py``).

The reference trains each model with a standalone script whose constants
are the configuration (``Code/settransformer.py:34-41,77-91``,
``Code/baseline.py``, ``Code/settransformertemp.py``,
``Code/baselinetemp.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pcaudio_torch.core.config import (
    ARCH_3ST, ARCH_CNN, ARCH_FB, ARCH_FST, ExperimentConfig)
from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.dsp.featurize import (
    FeaturizeConfig, batched_temporal_chunks, featurize_batch)
from pcaudio_torch.ops.cloud import (
    frame_cloud, freq_coords, grid_cloud, time_coords)
from pcaudio_torch.train.glue import dropout_apply, pointcloud_apply
from pcaudio_torch.train.step import TrainState

CLIPS_PER_PASS = 64  # clips featurized together: bounds the STFT's memory


def fst_config() -> ExperimentConfig:
    """``Code/settransformer.py``: Nfft=2048, dh=64, heads=8, inds=64,
    bs=128, Adam(1e-3, wd=1e-3), 500 epochs."""
    return ExperimentConfig(architecture=ARCH_FST, window_size=2048,
                            dhidden=64, nheads=8, ninds=64, batch_size=128,
                            learning_rate=1e-3, weight_decay=1e-3, epochs=500,
                            numpy_seed=1, torch_seed=1)


def fb_config() -> ExperimentConfig:
    """``Code/baseline.py``: layers [1025,513,256]→10, dropout 0.5, bs=128."""
    return ExperimentConfig(architecture=ARCH_FB, window_size=2048,
                            layers=[1025, 513, 256], dropout_prob=0.5,
                            batch_size=128, learning_rate=1e-3,
                            weight_decay=1e-3, epochs=500,
                            numpy_seed=0, torch_seed=0)


def st3_config() -> ExperimentConfig:
    """``Code/settransformertemp.py``: Nfft=1024, Ntemp=10, bs=16."""
    return ExperimentConfig(architecture=ARCH_3ST, window_size=1024, Ntemp=10,
                            dhidden=64, nheads=8, ninds=64, batch_size=16,
                            learning_rate=1e-3, weight_decay=1e-3, epochs=500,
                            numpy_seed=1, torch_seed=1)


def cnn_temp_config() -> ExperimentConfig:
    """``Code/baselinetemp.py``: CNN(Nt=10, Nf=512, [512,256,100]),
    Adam(1e-4, wd=1e-3), bs=128."""
    return ExperimentConfig(architecture=ARCH_CNN, window_size=1024, Ntemp=10,
                            Nt=10, Nf=512, layers=[512, 256, 100],
                            dropout_prob=0.5, batch_size=128,
                            learning_rate=1e-4, weight_decay=1e-3, epochs=500,
                            numpy_seed=0, torch_seed=0)

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


def _pooled(xs, ls, as_clouds: bool) -> Dict[str, np.ndarray]:
    return {"points" if as_clouds else "x": np.concatenate(xs),
            "labels": np.concatenate(ls).astype(np.int32)}


def prepare_framewise_data(waves, lengths, labels, cfg: ExperimentConfig,
                           device="cuda", as_clouds: Optional[bool] = None
                           ) -> Dict[str, np.ndarray]:
    """Waveforms → framewise training arrays: all valid frames pooled over
    clips, each with its clip's label (``Code/settransformer.py:43-68``).
    ``as_clouds=True`` gives FST clouds ``points [Nf, bins, 2]``, False FB
    frames ``x [Nf, bins]``; None chooses by ``cfg``'s model.  Featurized
    on ``device``; returned as host arrays."""
    as_clouds = cfg.is_set_model if as_clouds is None else as_clouds
    labels = np.asarray(labels)
    xs, ls = [], []
    for lm, fm, i in _featurized(waves, lengths, cfg, device):
        B, T, bins = lm.shape
        valid = fm.reshape(B * T)
        frames = lm.reshape(B * T, bins)[valid]
        if as_clouds:
            frames = frame_cloud(frames, freq_coords(
                bins, cfg.sampling_rate, device=frames.device))
        xs.append(frames.cpu().numpy())
        ls.append(np.repeat(labels[i: i + B], T)[valid.cpu().numpy()])
    return _pooled(xs, ls, as_clouds)


def prepare_temporal_data(waves, lengths, labels, cfg: ExperimentConfig,
                          device="cuda", as_clouds: Optional[bool] = None
                          ) -> Dict[str, np.ndarray]:
    """Waveforms → temporal training arrays: full ``Ntemp``-frame chunks
    pooled over clips (``Code/settransformertemp.py:50-59``).
    ``as_clouds=True`` gives 3ST clouds ``points [Nc, Ntemp·(bins-1), 3]``,
    False CNN grids ``x [Nc, Ntemp, bins-1]``; None chooses by ``cfg``'s
    model.  Featurized on ``device``; returned as host arrays."""
    as_clouds = cfg.is_set_model if as_clouds is None else as_clouds
    labels = np.asarray(labels)
    xs, ls = [], []
    for lm, fm, i in _featurized(waves, lengths, cfg, device):
        chunks, cmask = batched_temporal_chunks(lm, fm, cfg.Ntemp)
        B, C, Nt, bins = chunks.shape
        valid = cmask.reshape(B * C)
        flat = chunks.reshape(B * C, Nt, bins)[valid]
        if as_clouds:
            dev = flat.device
            flat = grid_cloud(
                flat, freq_coords(bins, cfg.sampling_rate, device=dev),
                time_coords(Nt, cfg.window_size, cfg.sampling_rate,
                            cfg.hop_factor, device=dev))
        xs.append(flat.cpu().numpy())
        ls.append(np.repeat(labels[i: i + B], C)[valid.cpu().numpy()])
    return _pooled(xs, ls, as_clouds)


def prepare_data(waves, lengths, labels, cfg: ExperimentConfig,
                 device="cuda") -> Dict[str, np.ndarray]:
    """The training arrays ``cfg``'s model takes: framewise or temporal by
    its input, clouds for a set model and grids for a baseline."""
    prep = prepare_framewise_data if cfg.is_framewise else prepare_temporal_data
    return prep(waves, lengths, labels, cfg, device=device)


def build_trainer(cfg: ExperimentConfig, device="cuda",
                  fused_attn: Optional[bool] = None
                  ) -> Tuple[TrainState, Callable]:
    """``(state, apply_fn)`` for a recipe config: a :class:`TrainState`
    holding the model, its weights drawn from ``cfg.torch_seed`` and placed
    on ``device`` (the card unless the caller names the CPU; no card
    raises), and its optimizer, the reference's ``torch.optim.Adam(lr,
    weight_decay)``, which the JAX package's ``adam_l2`` emulates.

    ``fused_attn`` routes a set model's attention through kernel K4;
    ``None`` means the kernel on a CUDA device and the plain version on the
    CPU.  A baseline's dropout masks come from ``state.generator``, a
    generator on ``device`` seeded from ``cfg.torch_seed`` that its adapter
    (:func:`dropout_apply`) draws from and a checkpoint saves.
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
    if cfg.is_set_model:
        return TrainState(model, optimizer), pointcloud_apply(model)
    generator = torch.Generator(device=device).manual_seed(cfg.torch_seed)
    return (TrainState(model, optimizer, generator=generator),
            dropout_apply(model, generator))
