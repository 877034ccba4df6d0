"""The temporal 3ST serving pipeline: waveform → point clouds → clip logits
(counterpart of ``pcaudio/eval/pipeline.py``, fused path only).

trim → STFT |X|² chunks (kernel K3) → exact top-K per chunk (kernel K2) →
log-magnitude of the K winners + affine (f, t) coordinates → ST forward
(kernel K1) → mean of the chunk logits over valid chunks.  Reference
semantics: ``Code/settransformertemp.py:35-59`` (n_fft 1024, Nyquist bin
dropped, 10-frame chunks, remainder dropped) and the ``ESC_pc_temp_maxKSS``
top-K clouds (``Code/dataset.py:169-202``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from pcaudio_torch.core.types import PointCloud
from pcaudio_torch.ops.kernels.featurize import (
    fused_chunk_mag2, fused_chunk_mag2_plain)
from pcaudio_torch.ops.kernels.fused_st import (
    fused_st_forward, fused_st_forward_plain)
from pcaudio_torch.ops.kernels.select import (
    exact_topk_chunks, exact_topk_chunks_plain)


@dataclasses.dataclass(frozen=True)
class TemporalPipelineConfig:
    """3ST pipeline config: the JAX package's fields and defaults, except
    that ``featurize``'s only ported value is ``"fused"`` and that the JAX
    package's ``approx_recall``, ``exact_kernel`` and ``st_block_b`` are
    absent.  Those three tune the TPU kernels (``lax.approx_max_k``'s
    recall, the Pallas select against ``lax.top_k``, the fused ST's clouds
    per grid step) and have no counterpart here; a config that passes them
    raises ``TypeError``."""

    fs: int = 44100
    target_fs: Optional[int] = None
    n_fft: int = 1024
    hop_factor: float = 0.5
    win_length: Optional[int] = None
    num_frames: int = 10
    top_k: Optional[int] = None
    trim: bool = True
    top_db: float = 60.0
    stft_precision: str = "highest"  # "default": serving log form
    compute_dtype: str = "float32"   # "bfloat16": bf16 grid and clouds
    extraction: str = "exact"
    featurize: str = "fused"

    def check_ported(self) -> None:
        """Raise for the JAX options the port does not have yet."""
        todo = "is not ported yet (ROADMAP Queue 1)"
        if self.featurize != "fused":
            raise NotImplementedError(f"featurize={self.featurize!r} {todo}")
        if self.extraction != "exact":
            raise NotImplementedError(f"extraction={self.extraction!r} {todo}")
        if self.target_fs is not None and self.target_fs != self.fs:
            raise NotImplementedError(f"resampling {todo}")
        if self.top_k is None:
            raise NotImplementedError(f"full-grid clouds (top_k=None) {todo}")
        if self.hop_factor != 0.5 or self.win_length not in (None, self.n_fft):
            raise ValueError("the fused featurize covers hop n_fft/2 and "
                             "win_length n_fft only")


def extract_chunk_clouds(waves: torch.Tensor, lengths: torch.Tensor,
                         cfg: TemporalPipelineConfig, plain: bool = False
                         ) -> Tuple[PointCloud, torch.Tensor]:
    """waveforms → per-chunk temporal top-K point clouds.

    Returns ``(cloud, chunk_mask [B, C])`` with ``cloud.points
    [B·C, K, 3]`` ``(f, t, log|X|)`` and ``cloud.mask [B·C, K]``.  ``waves``
    may be raw PCM int16 (divided by 32768 here).  ``plain=True`` runs the
    kernels' plain PyTorch versions whatever the device.
    """
    cfg.check_ported()
    if waves.dtype == torch.int16:
        waves = waves.float() * (1.0 / 32768.0)
    serving_bf16 = cfg.compute_dtype == "bfloat16"
    cdt = torch.bfloat16 if serving_bf16 else torch.float32
    grid_dt = (torch.bfloat16 if serving_bf16 and cfg.stft_precision != "highest"
               else torch.float32)
    featurize = fused_chunk_mag2_plain if plain else fused_chunk_mag2
    select = exact_topk_chunks_plain if plain else exact_topk_chunks
    m2, chunk_mask = featurize(waves, lengths, n_fft=cfg.n_fft,
                               num_frames=cfg.num_frames, trim=cfg.trim,
                               top_db=cfg.top_db, out_dtype=grid_dt)
    B, C, Nt, F = m2.shape
    k = cfg.top_k
    vals2, idx = select(m2.reshape(B * C, Nt, F), k)
    vals2, idx = vals2.reshape(B, C, k), idx.reshape(B, C, k)
    # log-magnitude of the winners only
    if cfg.stft_precision == "highest":
        vals = torch.log(1.0e-8 + torch.sqrt(vals2) / cfg.n_fft).to(cdt)
    else:
        # 0.5·log(v) − log(n) equals log(1e-8 + sqrt(v)/n) up to
        # O(1e-8·n/sqrt(v)); the floor pins silent points near log(1e-8)
        floor = (1.0e-8 * cfg.n_fft) ** 2
        vals = (0.5 * torch.log(vals2.clamp_min(floor))
                - math.log(cfg.n_fft)).to(cdt)
    # the (f, t) coordinates are linspace grids, affine in the flat index;
    # the steps are rounded to the cloud dtype first, as the JAX package
    # does, on the host (a device constant would make the host wait for the
    # kernels before it)
    cf = float(torch.tensor(0.5 / (F - 1), dtype=cdt))
    ct = float(torch.tensor(
        (cfg.hop_factor * cfg.n_fft / cfg.fs) * Nt / (Nt - 1), dtype=cdt))
    clouds = torch.stack([(idx % F).to(cdt) * cf, (idx // F).to(cdt) * ct,
                          vals], dim=-1)
    pmask = chunk_mask[:, :, None].expand(B, C, k)
    return (PointCloud(points=clouds.reshape(B * C, k, 3),
                       mask=pmask.reshape(B * C, k)), chunk_mask)


def _chunk_logits(model, waves, lengths, cfg, use_fused_st, plain):
    cloud, chunk_mask = extract_chunk_clouds(waves, lengths, cfg, plain=plain)
    B, C = chunk_mask.shape
    if use_fused_st:
        # mask=None: a top-K cloud is all valid or (invalid chunk) all
        # invalid; invalid chunks give finite logits that the chunk-mask
        # weighting drops
        st = fused_st_forward_plain if plain else fused_st_forward
        logits = st(model, cloud.points, None)
    else:
        logits = model(cloud.points.float(), cloud.mask)
    return logits.reshape(B, C, -1), chunk_mask


def make_temporal_classifier(model, cfg: TemporalPipelineConfig,
                             use_fused_st: bool = False, plain: bool = False):
    """Build ``fn(waves [B, L], lengths [B]) -> clip_logits [B, nclass]``:
    chunk logits averaged over valid chunks.  ``use_fused_st`` routes the
    ST through kernel K1; ``plain=True`` runs every kernel's plain version
    instead (the reference the kernels are held against)."""

    @torch.no_grad()
    def fn(waves: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        logits, chunk_mask = _chunk_logits(model, waves, lengths, cfg,
                                           use_fused_st, plain)
        w = chunk_mask[..., None].to(logits.dtype)
        return (logits * w).sum(1) / w.sum(1).clamp_min(1.0)

    return fn


def make_chunk_logits(model, cfg: TemporalPipelineConfig,
                      use_fused_st: bool = False, plain: bool = False):
    """Like :func:`make_temporal_classifier` but returns ``(chunk logits
    [B, C, nclass], chunk_mask [B, C])``, the reference's unit of
    evaluation."""

    @torch.no_grad()
    def fn(waves: torch.Tensor, lengths: torch.Tensor):
        return _chunk_logits(model, waves, lengths, cfg, use_fused_st, plain)

    return fn
