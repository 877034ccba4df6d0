"""The serving pipelines: the temporal 3ST's, waveform → point clouds → clip
logits (counterpart of ``pcaudio/eval/pipeline.py``), and the Audio
Spectrogram Transformer's, waveform → Kaldi log-mel grid → clip logits
(:func:`make_spectrogram_classifier`, port-only: the JAX package has no AST).

Two featurize paths, as in the JAX package:

* ``featurize="fused"``: trim → STFT |X|² chunks (kernel K3) → exact top-K
  per chunk (kernel K2) → log-magnitude of the K winners + affine (f, t)
  coordinates; with ``top_k=None`` the log-magnitude of every bin of the
  chunk and its linspace coordinates (no K2);
* ``featurize="xla"``: ``dsp/featurize.py::featurize_batch`` (trim,
  resampling when ``target_fs`` is set, the log-magnitude STFT at any hop
  and window) → ``batched_temporal_chunks`` → one flat top-K
  (``ops/subsample.py::topk_stable``) with affine coordinates, or with
  ``top_k=None`` the full-grid clouds of ``ops/cloud.py::grid_cloud``.
  These are plain PyTorch ops in place of XLA ops, not of a Pallas kernel.

``extraction="approx"`` selects on either path with kernel K2a
(``ops/kernels/approx_select.py``, the counterpart of ``lax.approx_max_k``)
in place of the exact top-K: on the fused path over the |X|² grid (a bf16
grid unless ``stft_precision="highest"``), on the ``"xla"`` path over the
chunks cast to bf16, whose bf16 values become the points' values.
``extraction="flat"`` selects the same set as ``"exact"`` on both paths
(the JAX package's flat ``lax.top_k`` where ``"exact"`` takes a two-stage
per-frame form; both are exact).

Then the ST forward (kernel K1 when ``use_fused_st``, which takes the full
5,120-point clouds too) and the mean of the chunk logits over valid chunks.
Reference semantics: ``Code/settransformertemp.py:35-59`` (n_fft 1024,
Nyquist bin dropped, 10-frame chunks, remainder dropped) and the
``ESC_pc_temp_maxKSS`` top-K clouds (``Code/dataset.py:169-202``).

Under a ``torch.profiler`` each call is a span ``pipeline.classify`` over
the stages' spans ``pipeline.featurize``, ``pipeline.select``,
``pipeline.clouds``, ``pipeline.st`` and ``pipeline.mean``, and it counts
the clouds handed to the ST (``pipeline.clouds_st``) and the valid ones
among them (``pipeline.clouds_valid``; ``utils/profiling.py``).  An AST call
is a span ``pipeline.classify`` over ``pipeline.fbank``, ``pipeline.embed``,
``pipeline.encoder`` (holding a ``pipeline.attn`` a K5 call) and
``pipeline.head``, and it counts the tokens (``pipeline.tokens``) and the
frames made from the clips' samples (``pipeline.frames_valid``).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional, Tuple

import torch

from pcaudio_torch.core.types import PointCloud
from pcaudio_torch.dsp.fbank import AUDIOSET_MEAN, AUDIOSET_STD, fbank_batch
from pcaudio_torch.dsp.featurize import (
    FeaturizeConfig, batched_temporal_chunks, featurize_batch)
from pcaudio_torch.ops.cloud import freq_coords, grid_cloud, time_coords
from pcaudio_torch.ops.kernels.approx_select import (
    approx_topk_chunks, approx_topk_chunks_plain)
from pcaudio_torch.ops.kernels.attn import attn_fwd, attn_fwd_plain
from pcaudio_torch.ops.kernels.featurize import (
    fused_chunk_mag2, fused_chunk_mag2_plain)
from pcaudio_torch.ops.kernels.fused_st import (
    fused_st_forward, fused_st_forward_plain)
from pcaudio_torch.ops.kernels.select import (
    exact_topk_chunks, exact_topk_chunks_plain)
from pcaudio_torch.ops.subsample import topk_stable
from pcaudio_torch.utils.profiling import count, count_device, span


@dataclasses.dataclass(frozen=True)
class TemporalPipelineConfig:
    """3ST pipeline config: the JAX package's fields, except that the JAX
    package's ``exact_kernel`` and ``st_block_b`` are absent.  Those two
    tune the TPU kernels (the Pallas select against ``lax.top_k``, the
    fused ST's clouds per grid step) and have no counterpart here; a config
    that passes them raises ``TypeError``.

    ``extraction``: ``"exact"`` (the default), ``"flat"`` (the same set)
    or ``"approx"``, the top K of XLA's window maxima at the recall target
    ``approx_recall`` (``approx_select.py::approx_topk_plan``).

    ``featurize`` defaults to ``"fused"``, where the JAX package's default
    is ``"xla"``: the fused path is the one the kernels serve and
    ``bench.py`` measures, and it takes the same top-K sets (the tests hold
    the two paths to each other).  ``"xla"`` is the path for resampling
    (``target_fs``), another hop or another window."""

    fs: int = 44100
    target_fs: Optional[int] = None
    n_fft: int = 1024
    hop_factor: float = 0.5
    win_length: Optional[int] = None
    num_frames: int = 10
    top_k: Optional[int] = None    # None: full Nt·(n_fft/2)-point clouds
    trim: bool = True
    top_db: float = 60.0
    stft_precision: str = "highest"  # "default": serving log form
    compute_dtype: str = "float32"   # "bfloat16": bf16 grid and clouds
    extraction: str = "exact"
    featurize: str = "fused"
    approx_recall: float = 0.9

    def check_ported(self) -> None:
        """Raise ``ValueError`` for an unknown ``extraction`` or
        ``featurize``, an ``approx_recall`` outside (0, 1] in approx mode,
        and a fused featurize outside the serving config (resampling,
        another hop or window), as the JAX package asserts.

        Two fused configs serve here that the JAX ``_extract_fused``
        refuses, both port-only: ``top_k=None`` (full grids; the JAX
        package asserts a top-K budget), kept so that the port's default
        config (``featurize="fused"``, ``top_k=None``) serves, and
        ``target_fs == fs`` (no resampling).  Their tests hold them to the
        JAX package's ``"xla"`` path."""
        if self.extraction not in ("exact", "flat", "approx"):
            raise ValueError(f"extraction must be 'exact', 'flat' or 'approx', "
                             f"got {self.extraction!r}")
        if self.extraction == "approx" and not 0.0 < self.approx_recall <= 1.0:
            raise ValueError(f"approx_recall must lie in (0, 1], got "
                             f"{self.approx_recall}")
        if self.featurize not in ("fused", "xla"):
            raise ValueError(f"featurize must be 'fused' or 'xla', got "
                             f"{self.featurize!r}")
        if self.featurize == "fused" and (
                self.target_fs not in (None, self.fs) or self.hop_factor != 0.5
                or self.win_length not in (None, self.n_fft)):
            raise ValueError("the fused featurize covers hop n_fft/2, "
                             "win_length n_fft and no resampling; use "
                             "featurize='xla'")

    def featurize_config(self) -> FeaturizeConfig:
        return FeaturizeConfig(
            fs=self.fs, target_fs=self.target_fs, n_fft=self.n_fft,
            hop_factor=self.hop_factor, win_length=self.win_length,
            top_db=self.top_db, trim=self.trim,
            precision=self.stft_precision, out_dtype=self.compute_dtype)


def extract_chunk_clouds(waves: torch.Tensor, lengths: torch.Tensor,
                         cfg: TemporalPipelineConfig, plain: bool = False
                         ) -> Tuple[PointCloud, torch.Tensor]:
    """waveforms → per-chunk temporal point clouds.

    Returns ``(cloud, chunk_mask [B, C])`` with ``cloud.points
    [B·C, K, 3]`` ``(f, t, log|X|)``, ``K = top_k`` or ``Nt·(n_fft/2)``, and
    ``cloud.mask [B·C, K]`` (the chunk mask broadcast).  ``waves`` may be
    raw PCM int16 (divided by 32768 here).  ``plain=True`` runs the
    kernels' plain PyTorch versions whatever the device.
    """
    cfg.check_ported()
    if waves.dtype == torch.int16:
        waves = waves.float() * (1.0 / 32768.0)
    if cfg.featurize == "fused":
        clouds, chunk_mask = _clouds_fused(waves, lengths, cfg, plain)
    else:
        clouds, chunk_mask = _clouds_xla(waves, lengths, cfg, plain)
    with span("pipeline.clouds"):
        B, C, K = clouds.shape[:3]
        pmask = chunk_mask[:, :, None].expand(B, C, K)
        return (PointCloud(points=clouds.reshape(B * C, K, 3),
                           mask=pmask.reshape(B * C, K)), chunk_mask)


def _affine_clouds(idx: torch.Tensor, vals: torch.Tensor, F: int, Nt: int,
                   cfg: TemporalPipelineConfig, fs: int) -> torch.Tensor:
    """``(f, t, vals)`` of flat frequency-fastest indices ``idx``: the
    (f, t) coordinates are linspace grids, affine in the flat index; the
    steps are rounded to the cloud dtype first, as the JAX package does, on
    the host (a device constant would make the host wait for the kernels
    before it)."""
    dt = vals.dtype
    cf = float(torch.tensor(0.5 / (F - 1), dtype=dt))
    ct = float(torch.tensor((cfg.hop_factor * cfg.n_fft / fs) * Nt / (Nt - 1),
                            dtype=dt))
    return torch.stack([(idx % F).to(dt) * cf, (idx // F).to(dt) * ct, vals],
                       dim=-1)


def _clouds_fused(waves, lengths, cfg, plain):
    """K3's |X|² chunks, then K2's top K, or K2a's in approx mode
    (log-magnitude of the winners only) or, at ``top_k=None``, every bin:
    ``(clouds [B, C, K, 3], chunk_mask)``.  The grid is bf16 in approx mode
    or at ``compute_dtype="bfloat16"``, unless ``stft_precision="highest"``
    (the JAX ``_extract_fused``'s rule)."""
    approx = cfg.extraction == "approx"
    serving_bf16 = cfg.compute_dtype == "bfloat16"
    cdt = torch.bfloat16 if serving_bf16 else torch.float32
    grid_dt = (torch.bfloat16 if (approx or serving_bf16)
               and cfg.stft_precision != "highest" else torch.float32)
    featurize = fused_chunk_mag2_plain if plain else fused_chunk_mag2
    with span("pipeline.featurize"):
        m2, chunk_mask = featurize(waves, lengths, n_fft=cfg.n_fft,
                                   num_frames=cfg.num_frames, trim=cfg.trim,
                                   top_db=cfg.top_db, out_dtype=grid_dt)
    B, C, Nt, F = m2.shape
    k = cfg.top_k
    vals2 = m2
    if k is not None:
        with span("pipeline.select"):
            if approx:
                select = approx_topk_chunks_plain if plain else approx_topk_chunks
                vals2, idx = select(m2.reshape(B * C, Nt * F), k, cfg.approx_recall)
            else:
                select = exact_topk_chunks_plain if plain else exact_topk_chunks
                vals2, idx = select(m2.reshape(B * C, Nt, F), k)
            vals2, idx = vals2.reshape(B, C, k), idx.reshape(B, C, k)
    with span("pipeline.clouds"):
        if cfg.stft_precision == "highest":
            vals = torch.log(1.0e-8 + torch.sqrt(vals2.float()) / cfg.n_fft).to(cdt)
        else:
            # 0.5·log(v) − log(n) equals log(1e-8 + sqrt(v)/n) up to
            # O(1e-8·n/sqrt(v)); the floor pins silent points near log(1e-8)
            floor = (1.0e-8 * cfg.n_fft) ** 2
            vals = (0.5 * torch.log(vals2.float().clamp_min(floor))
                    - math.log(cfg.n_fft)).to(cdt)
        if k is not None:
            return _affine_clouds(idx, vals, F, Nt, cfg, cfg.fs), chunk_mask
        return _full_clouds(vals, Nt, F, cfg, cfg.fs), chunk_mask


def _full_clouds(grid, Nt, F, cfg, fs):
    """Every bin of ``[B, C, Nt, F]`` log-magnitude chunks, frequency
    fastest, as f32 (the JAX ``grid_cloud`` stacks onto f32 coordinates)."""
    dev = grid.device
    return grid_cloud(grid.float(), freq_coords(F, fs, device=dev),
                      time_coords(Nt, cfg.n_fft, fs, cfg.hop_factor, device=dev))


def _clouds_xla(waves, lengths, cfg, plain):
    """``featurize_batch`` → chunks → one flat stable top K (the JAX
    two-stage per-frame form selects the same set in the same order), K2a
    on the chunks' bf16 keys in approx mode (the points take the bf16
    values, cast back to the chunk dtype), or the full grid: ``(clouds
    [B, C, K, 3], chunk_mask)``."""
    with span("pipeline.featurize"):
        logmag, frame_mask = featurize_batch(waves, lengths, cfg.featurize_config())
        chunks, chunk_mask = batched_temporal_chunks(logmag, frame_mask,
                                                     cfg.num_frames)
    B, C, Nt, F = chunks.shape
    eff_fs = cfg.target_fs or cfg.fs
    k = cfg.top_k
    if k is None or k >= Nt * F:
        with span("pipeline.clouds"):
            return _full_clouds(chunks, Nt, F, cfg, eff_fs), chunk_mask
    with span("pipeline.select"):
        if cfg.extraction == "approx":
            select = approx_topk_chunks_plain if plain else approx_topk_chunks
            keys = chunks.reshape(B * C, Nt * F).to(torch.bfloat16)
            bvals, idx = select(keys, k, cfg.approx_recall)
            idx = idx.reshape(B, C, k)
        else:
            vals, idx = topk_stable(chunks.reshape(B, C, Nt * F), k)
    with span("pipeline.clouds"):
        if cfg.extraction == "approx":
            vals = bvals.to(chunks.dtype).reshape(B, C, k)
        return _affine_clouds(idx, vals, F, Nt, cfg, eff_fs), chunk_mask


def _chunk_logits(model, waves, lengths, cfg, use_fused_st, plain):
    cloud, chunk_mask = extract_chunk_clouds(waves, lengths, cfg, plain=plain)
    B, C = chunk_mask.shape
    count("pipeline.clouds_st", B * C)
    count_device("pipeline.clouds_valid", chunk_mask)
    with span("pipeline.st"):
        if use_fused_st:
            # every cloud here (top K or the full grid) is all valid or
            # (invalid chunk) all invalid, and cloud.mask is the chunk mask
            # broadcast: K1 takes it as a flag a cloud, runs the valid
            # chunks' clouds unmasked and gives the invalid ones the logits
            # of an empty cloud without a forward; the chunk-mask weighting
            # drops those.  K1 takes the full 5,120-point grids in its
            # scratch form
            st = fused_st_forward_plain if plain else fused_st_forward
            logits = st(model, cloud.points, cloud.mask)
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
        with span("pipeline.classify"):
            logits, chunk_mask = _chunk_logits(model, waves, lengths, cfg,
                                               use_fused_st, plain)
            with span("pipeline.mean"):
                w = chunk_mask[..., None].to(logits.dtype)
                return (logits * w).sum(1) / w.sum(1).clamp_min(1.0)

    return fn


def make_chunk_logits(model, cfg: TemporalPipelineConfig,
                      use_fused_st: bool = False, plain: bool = False):
    """Like :func:`make_temporal_classifier` but returns ``(chunk logits
    [B, C, nclass], chunk_mask [B, C])``, the reference's unit of
    evaluation.

    With ``use_fused_st`` an invalid chunk (``chunk_mask`` false) gets the
    logits of an empty cloud, the masked ST's: this departs from the JAX
    reference's fused path (``pcaudio/eval/pipeline.py``), which runs it
    unmasked, and matches its ``use_fused_st=False`` path.  Valid chunks'
    logits and the clip logits are the same either way."""

    @torch.no_grad()
    def fn(waves: torch.Tensor, lengths: torch.Tensor):
        with span("pipeline.classify"):
            return _chunk_logits(model, waves, lengths, cfg, use_fused_st, plain)

    return fn


@dataclasses.dataclass(frozen=True)
class SpectrogramPipelineConfig:
    """The AST's front end: 16 kHz clips, ``num_mel_bins`` Kaldi log-mel
    bins, ``max_length`` frames, normalised by ``mean`` and ``std``
    (``dsp/fbank.py``)."""

    fs: int = 16000
    num_mel_bins: int = 128
    max_length: int = 1024
    mean: float = AUDIOSET_MEAN
    std: float = AUDIOSET_STD


def make_spectrogram_classifier(model, cfg: SpectrogramPipelineConfig,
                                plain: bool = False):
    """Build ``fn(waves [B, L], lengths [B]) -> logits [B, num_labels]`` f32
    for an ``AST`` (``nn/ast.py``): the log-mel grid, then the model in bf16
    (a bf16 copy of ``model`` where its parameters are in another type).
    Attention runs through kernel K5 (its plain twin on CPU tensors);
    ``plain=True`` takes the twin whatever the device.  ``waves`` may be raw
    PCM int16 (divided by 32768 here)."""
    if model.num_mel_bins != cfg.num_mel_bins or model.max_length != cfg.max_length:
        raise ValueError(f"the model takes {model.max_length} x {model.num_mel_bins} grids, "
                         f"the pipeline makes {cfg.max_length} x {cfg.num_mel_bins}")
    net = model
    if any(p.dtype != torch.bfloat16 for p in model.parameters()):
        net = copy.deepcopy(model).to(torch.bfloat16)
    net.eval()
    attend = attn_fwd_plain if plain else attn_fwd

    @torch.no_grad()
    def fn(waves: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        with span("pipeline.classify"):
            if waves.dtype == torch.int16:
                waves = waves.float() * (1.0 / 32768.0)
            with span("pipeline.fbank"):
                feats, frames = fbank_batch(waves, lengths, cfg.num_mel_bins,
                                            cfg.max_length, cfg.mean, cfg.std, cfg.fs)
            count("pipeline.tokens", waves.shape[0] * net.num_tokens)
            count_device("pipeline.frames_valid", frames)
            with span("pipeline.embed"):
                x = net.embed(feats)
            with span("pipeline.encoder"):
                x = net.encode(x, attend)
            with span("pipeline.head"):
                return net.classify(x)

    return fn
