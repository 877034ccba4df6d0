"""The paper's evaluation sweeps (counterpart of
``pcaudio/eval/experiments.py``) for its four models.

The reference's eval scripts (``Code/pceval.py`` for FST,
``Code/baseline_eval.py`` for FB, ``Code/pc_temp3d_eval.py`` for 3ST,
``Code/baseline_temp_eval.py`` for CNN_temp) re-run the classifier under
shifted conditions.  The emitted dicts serialize to exactly the reference's
``Code/paper_plots/*.json`` schemas:

  expt1:  ``{"data": {Fs: [acc per N]}, "list_Fs": [...], "list_N": [...]}``
  expt2:  ``{"data": {K: [mean, var]}, "list_K": [...]}``

Featurization per sweep point (``pceval.py:76``): ``n_fft =
2^ceil(log2 N)``, window N, hop ``N·hf``, magnitude / N, the clip trimmed at
the original rate and then resampled to Fs; the temporal variant drops the
Nyquist row and chunks into Ntemp frames (``pc_temp3d_eval.py:75-78``).
The grid baselines take a fixed input width, so their sweep pins n_fft to
the training window (``fixed_nfft``: the window shrinks inside it, the
magnitude is divided by n_fft, and no window is longer than it;
``Code/baseline_eval.py:54``).  Expt 2 keeps K points of each cloud:
the K largest log-magnitudes (maxK) and ``nruns`` uniform random K-subsets
(randK, ``pceval.py:114``); the baselines' "replace" mode zeroes the
grid's other bins instead (``baseline_eval.py:105-183``), the grid ranked
by its own values and, for CNN_temp, flattened frequency-fastest.

Expt 2 is a rank mask over the full cloud in original point order:
``rank < K`` where ``rank`` is a point's place in a stable descending sort
of its log-magnitude (maxK; ties to the lower index, as ``lax.top_k``) or of
uniform noise (randK: sampling without replacement), and the model takes
the mask as its key mask.  One set of ranks serves every K.  The random
draws come from a ``torch.Generator`` seeded from ``seed`` and the
microbatch index, so they cannot match ``jax.random``'s bit for bit; the
maxK counts are deterministic.

Not ported, because each works around an XLA compile or a TPU dispatch
cost that eager PyTorch does not have: ``_SweepPrefetcher`` and
``_compile_workers`` (compiles of sweep points in threads), the
``PCAUDIO_EVAL_K_CHUNK`` slicing of the K axis and the padding of the last
microbatch (one compiled program).

Deviation kept from the JAX package: accuracy is over ALL valid frames or
chunks, where the reference drops the shuffled DataLoader's last partial
batch.  The port classifies only the valid rows, where the JAX package
classifies every row of the padded batch and counts the valid ones: the
accuracies are the same.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.dsp.featurize import (
    FeaturizeConfig, batched_temporal_chunks, featurize_kept,
    trim_and_resample)
from pcaudio_torch.ops.cloud import (
    frame_cloud, freq_coords, grid_cloud, time_coords)

# classifier rows a call (the JAX package's defaults): frames of up to
# 2049 points, temporal chunks of up to 10240
_MB_FRAMES = 1024
_MB_CHUNKS = 256
CLIPS_PER_PASS = 64  # clips featurized together: bounds the STFT's memory


def default_list_N(Nfft: int, include_larger: bool = True) -> List[int]:
    """The reference window sweep (``Code/pceval.py:56``); set models also
    take windows longer than the training window."""
    larger = [2 * Nfft, int(1.5 * Nfft), int(1.25 * Nfft), int(1.05 * Nfft)]
    base = [Nfft, int(0.95 * Nfft), int(0.9 * Nfft), int(0.8 * Nfft),
            int(0.7 * Nfft), int(0.6 * Nfft), int(0.5 * Nfft),
            int(0.25 * Nfft), int(0.1 * Nfft)]
    return (larger if include_larger else []) + base


def default_list_Fs(fsog: int) -> List:
    """``[fsog, 32000, 0.5·fsog, 0.25·fsog]``: float rates stay floats, so
    the JSON keys read as the reference's ("22050.0")."""
    return [fsog, 32000, 0.5 * fsog, 0.25 * fsog]


def default_list_K(n_total: int) -> List[int]:
    """``arange(1, n_total, 50)`` with the last entry snapped to ``n_total``
    (``Code/pceval.py:111-113``)."""
    ks = list(np.arange(1, n_total, 50))
    ks[-1] = n_total
    return [int(k) for k in ks]


def sweep_featurize_config(F, N: int, *, fsog: int, hf: float, tDb: float,
                           fixed_nfft: Optional[int] = None) -> FeaturizeConfig:
    """Featurizer for one (sampling-rate, window) sweep point: n_fft is
    ``2^ceil(log2 N)`` and the magnitude is divided by N, or, with
    ``fixed_nfft`` (the grid baselines), both are ``fixed_nfft``."""
    pinned = fixed_nfft is not None
    return FeaturizeConfig(
        fs=fsog,
        target_fs=None if int(F) == fsog else int(F),
        n_fft=fixed_nfft if pinned else 2 ** int(math.ceil(math.log2(N))),
        win_length=N,
        hop_length_override=int(N * hf),
        mag_norm=float(fixed_nfft) if pinned else float(N),
        top_db=tDb,
        trim=True,
    )


def _kept(waves, lengths, cfg: FeaturizeConfig):
    """:func:`trim_and_resample` over groups of ``CLIPS_PER_PASS`` clips,
    each group's buffers first cut to its longest clip: no valid frame
    reads past a clip's length, so the valid frames are the same."""
    out = []
    for i in range(0, len(waves), CLIPS_PER_PASS):
        n = lengths[i: i + CLIPS_PER_PASS]
        longest = max(int(n.max()), 1)
        out.append(trim_and_resample(waves[i: i + CLIPS_PER_PASS, :longest],
                                     n, cfg))
    return out


def _featurize(kept, cfg: FeaturizeConfig):
    """:func:`featurize_kept` of :func:`_kept`'s groups, concatenated:
    ``featurize_batch`` of the whole batch."""
    parts = [featurize_kept(*k, cfg) for k in kept]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _sweep_configs(F, list_N, fsog, hf, tDb, fixed_nfft=None):
    """The featurizers of one rate's sweep points; trim and resampling
    depend on the rate alone, so the sweep runs them once a rate."""
    return [sweep_featurize_config(F, N, fsog=fsog, hf=hf, tDb=tDb,
                                   fixed_nfft=fixed_nfft)
            for N in list_N]


def _valid_frames(logmag: torch.Tensor, mask: torch.Tensor,
                  labels: torch.Tensor):
    """Flatten ``[B, T, F]`` to frames ``[B·T, F]``, their validity and
    their clips' labels (the reference concatenates frames over clips,
    ``Code/pceval.py:77-80``)."""
    B, T, F = logmag.shape
    return (logmag.reshape(B * T, F), mask.reshape(B * T),
            labels.repeat_interleave(T))


def _temporal_rows(logmag, mask, labels, Ntemp: int):
    """``[B, T, F]`` → chunks ``[B·C, Ntemp, F-1]``, their validity and
    their clips' labels."""
    chunks, cmask = batched_temporal_chunks(logmag, mask, Ntemp)
    B, C, Nt, bins = chunks.shape
    return (chunks.reshape(B * C, Nt, bins), cmask.reshape(B * C),
            labels.repeat_interleave(C))


def _hits(logits: torch.Tensor, labels: torch.Tensor,
          valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Correct predictions among the valid rows (every row where ``valid``
    is None), an int64 device scalar."""
    ok = logits.argmax(-1) == labels
    return (ok if valid is None else ok & valid).sum()


def _sweep_accuracy(classify: Callable, rows: torch.Tensor,
                    labels: torch.Tensor, mb: int) -> float:
    """Accuracy of ``classify`` over ``rows`` (all valid), called on
    microbatches of ``mb`` rows: exact integer counts, kept on the device
    until the end, and a float64 host division (the JAX ``_accuracy``)."""
    hits = torch.zeros((), dtype=torch.int64, device=rows.device)
    for i in range(0, rows.shape[0], mb):
        hits += _hits(classify(rows[i: i + mb]), labels[i: i + mb])
    return int(hits) / max(rows.shape[0], 1)


def _inputs(device, waves, lengths, labels):
    device = resolve_device(device)
    return (device, torch.as_tensor(waves).to(device, torch.float32),
            torch.as_tensor(lengths).to(device),
            torch.as_tensor(labels).to(device, torch.int64))


# ---------------------------------------------------------------------------
# the rank-mask engine
# ---------------------------------------------------------------------------

def _ranks_desc(x: torch.Tensor) -> torch.Tensor:
    """``rank[..., i]`` = place of element ``i`` in the stable descending
    order of the last axis, so ``rank < K`` selects exactly
    ``jax.lax.top_k(x, K)``'s elements (ties to the lower index, -0.0
    tying with 0.0, as in the JAX function's stable sort of ``-x``)."""
    order = torch.argsort(-x, dim=-1, stable=True)
    iota = torch.arange(x.shape[-1], device=x.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, iota)


def _mask_counts(apply_masked: Callable, x: torch.Tensor, rmax: torch.Tensor,
                 rrand: torch.Tensor, labels: torch.Tensor,
                 valid: Optional[torch.Tensor], list_K: Sequence[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Correct predictions for each K of ``list_K``, keeping ``rmax < K``
    (maxK) and each of the ``R`` rank sets ``rrand [R, ...] < K`` (randK).

    ``apply_masked(x, keep [..., n] bool) -> logits``.  Returns
    ``(counts_max [nK], counts_rand [nK, R])``, int64 on ``x``'s device."""
    R = rrand.shape[0]
    cmax = torch.zeros(len(list_K), dtype=torch.int64, device=x.device)
    crand = torch.zeros(len(list_K), R, dtype=torch.int64, device=x.device)
    for j, K in enumerate(list_K):
        cmax[j] = _hits(apply_masked(x, rmax < K), labels, valid)
        for r in range(R):
            crand[j, r] = _hits(apply_masked(x, rrand[r] < K), labels, valid)
    return cmax, crand


def _prefix_mask_counts(apply_masked: Callable, x: torch.Tensor,
                        rank_src: torch.Tensor, labels: torch.Tensor,
                        valid: Optional[torch.Tensor], gen: torch.Generator,
                        list_K: Sequence[int], R: int):
    """The K sweep of one microbatch: maxK ranks from ``rank_src [..., n]``,
    randK ranks from ``R`` draws of uniform noise from ``gen`` (ranking the
    noise samples without replacement), then :func:`_mask_counts`."""
    noise = torch.rand((R,) + tuple(rank_src.shape), generator=gen,
                       device=rank_src.device)
    return _mask_counts(apply_masked, x, _ranks_desc(rank_src),
                        _ranks_desc(noise), labels, valid, list_K)


def _microbatch_generator(seed: int, mb_index: int,
                          device: torch.device) -> torch.Generator:
    state = np.random.SeedSequence([seed, mb_index]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _run_masked_sweep(mb_counts: Callable, arrays: Sequence[torch.Tensor],
                      labels: torch.Tensor, seed: int,
                      list_K: Sequence[int], mb: int, R: int):
    """The microbatch loop of a K sweep over rows that are all valid: calls
    ``mb_counts(*slices, labels_mb, gen, list_K)`` on axis-0 slices of
    ``arrays`` of ``mb`` rows, with a generator per microbatch, sums the
    counts on the device, and returns the reference-schema dicts
    ``(randK {"data": {K: [mean, var]}}, maxK {"data": {K: [acc, 0]}})``."""
    n = labels.shape[0]
    cmax = torch.zeros(len(list_K), dtype=torch.int64, device=labels.device)
    crand = torch.zeros(len(list_K), R, dtype=torch.int64, device=labels.device)
    for mb_i, i in enumerate(range(0, n, mb)):
        a, b = mb_counts(*(t[i: i + mb] for t in arrays), labels[i: i + mb],
                         _microbatch_generator(seed, mb_i, labels.device),
                         list_K)
        cmax += a
        crand += b
    nvalid = max(n, 1)
    cmax, crand = cmax.cpu().numpy(), crand.cpu().numpy()
    accs_rand = crand / nvalid  # [nK, R]
    rand_out = {"data": {}, "list_K": [int(k) for k in list_K]}
    max_out = {"data": {}, "list_K": [int(k) for k in list_K]}
    for j, K in enumerate(list_K):
        rand_out["data"][int(K)] = [float(np.mean(accs_rand[j])),
                                    float(np.var(accs_rand[j]))]
        max_out["data"][int(K)] = [float(cmax[j] / nvalid), 0]
    return rand_out, max_out


# ---------------------------------------------------------------------------
# experiment 1: (Fs, N) robustness sweeps
# ---------------------------------------------------------------------------

def _expt1_lists(fsog, Nfft, list_Fs, list_N, fixed_nfft):
    """The sweep's rates and windows; a pinned n_fft takes no window
    longer than the training window (``Code/baseline_eval.py:54``)."""
    list_Fs = list(default_list_Fs(fsog) if list_Fs is None else list_Fs)
    if list_N is None:
        list_N = default_list_N(Nfft, include_larger=not fixed_nfft)
    list_N = [int(n) for n in list_N]
    if fixed_nfft and max(list_N) > Nfft:
        raise ValueError(f"windows {list_N} exceed the pinned n_fft {Nfft}")
    return list_Fs, list_N


@torch.no_grad()
def framewise_expt1(frame_classifier: Callable, waves, lengths, labels, *,
                    fsog: int = 44100, Nfft: int = 2048, hf: float = 0.5,
                    tDb: float = 60.0, fixed_nfft: bool = False,
                    list_Fs: Optional[Sequence] = None,
                    list_N: Optional[Sequence[int]] = None,
                    device="cuda") -> Dict:
    """FST / FB experiment 1 (``Code/pceval.py:55-105`` /
    ``Code/baseline_eval.py:53-103``): the accuracy over the valid frames
    of the clips at each rate of ``list_Fs`` and window of ``list_N``.

    ``frame_classifier(frames [Nb, bins], farr [bins]) -> logits`` (see
    :func:`make_fst_frame_classifier`, :func:`make_fb_frame_classifier`).
    ``fixed_nfft=True`` is FB's featurization: n_fft pinned to ``Nfft``.
    Runs on ``device``."""
    device, waves, lengths, labels = _inputs(device, waves, lengths, labels)
    list_Fs, list_N = _expt1_lists(fsog, Nfft, list_Fs, list_N, fixed_nfft)
    out = {"data": {F: [] for F in list_Fs}, "list_Fs": list_Fs,
           "list_N": list_N}
    for F in list_Fs:
        cfgs = _sweep_configs(F, list_N, fsog, hf, tDb,
                              Nfft if fixed_nfft else None)
        kept = _kept(waves, lengths, cfgs[0])
        for cfg in cfgs:
            frames, valid, flabels = _valid_frames(*_featurize(kept, cfg),
                                                   labels)
            farr = freq_coords(frames.shape[-1], int(F), device=device)
            out["data"][F].append(_sweep_accuracy(
                lambda x: frame_classifier(x, farr), frames[valid],
                flabels[valid], _MB_FRAMES))
    return out


@torch.no_grad()
def temporal_expt1(chunk_classifier: Callable, waves, lengths, labels, *,
                   fsog: int = 44100, Nfft: int = 1024, Ntemp: int = 10,
                   hf: float = 0.5, tDb: float = 60.0,
                   fixed_nfft: bool = False,
                   list_Fs: Optional[Sequence] = None,
                   list_N: Optional[Sequence[int]] = None,
                   device="cuda") -> Dict:
    """3ST / CNN_temp experiment 1 (``Code/pc_temp3d_eval.py:56-106`` /
    ``Code/baseline_temp_eval.py:53-102``) over the valid ``Ntemp``-frame
    chunks.

    ``chunk_classifier(chunks [Nb, Ntemp, bins], farr, tarr) -> logits``;
    ``tarr`` is recomputed with the sweep's window and rate
    (``Code/pc_temp3d_eval.py:87``).  ``fixed_nfft=True`` is CNN_temp's
    featurization: n_fft pinned to ``Nfft``."""
    device, waves, lengths, labels = _inputs(device, waves, lengths, labels)
    list_Fs, list_N = _expt1_lists(fsog, Nfft, list_Fs, list_N, fixed_nfft)
    out = {"data": {F: [] for F in list_Fs}, "list_Fs": list_Fs,
           "list_N": list_N}
    for F in list_Fs:
        cfgs = _sweep_configs(F, list_N, fsog, hf, tDb,
                              Nfft if fixed_nfft else None)
        kept = _kept(waves, lengths, cfgs[0])
        for N, cfg in zip(list_N, cfgs):
            flat, valid, clabels = _temporal_rows(*_featurize(kept, cfg),
                                                  labels, Ntemp)
            Nt, bins = flat.shape[1:]
            farr = freq_coords(bins, int(F), device=device)
            tarr = torch.linspace(0.0, (hf * N / int(F)) * Nt, Nt,
                                  dtype=torch.float32, device=device)
            out["data"][F].append(_sweep_accuracy(
                lambda x: chunk_classifier(x, farr, tarr), flat[valid],
                clabels[valid], _MB_CHUNKS))
    return out


# ---------------------------------------------------------------------------
# experiment 2: subsampling curves
# ---------------------------------------------------------------------------

@torch.no_grad()
def framewise_expt2(frame_classifier: Optional[Callable],
                    cloud_classifier: Callable, waves, lengths, labels, *,
                    mode: str, fsog: int = 44100, Nfft: int = 2048,
                    hf: float = 0.5, tDb: float = 60.0,
                    list_K: Optional[Sequence[int]] = None, nruns: int = 10,
                    seed: int = 0, device="cuda"):
    """FST / FB experiment 2 (``Code/pceval.py:107-192`` /
    ``Code/baseline_eval.py:105-183``).  Returns ``(randK_dict,
    maxK_dict)``.

    Mode "cloud" (FST): ``cloud_classifier(points [Nb, n, 2], mask [Nb, n])
    -> logits``; every K and run reuses the microbatch's clouds with
    another key mask (the engine note above).  Mode "replace" (FB):
    ``frame_classifier(frames [Nb, bins], farr)`` on the frames with the
    unkept bins zeroed, the kept ones chosen by the same ranks."""
    if mode not in ("cloud", "replace"):
        raise ValueError(f"mode must be 'cloud' or 'replace', got {mode!r}")
    device, waves, lengths, labels = _inputs(device, waves, lengths, labels)
    list_K = (default_list_K(Nfft // 2) if list_K is None
              else [int(k) for k in list_K])
    cfg = FeaturizeConfig(fs=fsog, n_fft=Nfft, top_db=tDb, trim=True)
    frames, valid, flabels = _valid_frames(
        *_featurize(_kept(waves, lengths, cfg), cfg), labels)
    farr = freq_coords(frames.shape[-1], fsog, device=device)
    R = int(nruns)

    def mb_counts(frames_mb, labels_mb, gen, Ks):
        if mode == "cloud":
            return _prefix_mask_counts(cloud_classifier,
                                       frame_cloud(frames_mb, farr), frames_mb,
                                       labels_mb, None, gen, Ks, R)
        return _prefix_mask_counts(
            lambda fr, keep: frame_classifier(torch.where(keep, fr, 0.0), farr),
            frames_mb, frames_mb, labels_mb, None, gen, Ks, R)

    return _run_masked_sweep(mb_counts, [frames[valid]], flabels[valid], seed,
                             list_K, _MB_FRAMES, R)


@torch.no_grad()
def temporal_expt2(cloud_classifier: Callable,
                   grid_classifier: Optional[Callable], waves, lengths,
                   labels, *, mode: str, fsog: int = 44100, Nfft: int = 1024,
                   Ntemp: int = 10, hf: float = 0.5, tDb: float = 60.0,
                   list_K: Optional[Sequence[int]] = None, nruns: int = 10,
                   seed: int = 0, device="cuda"):
    """3ST / CNN_temp experiment 2 (``Code/pc_temp3d_eval.py:109-200`` /
    ``Code/baseline_temp_eval.py:104-197``), the engine of
    :func:`framewise_expt2` over temporal clouds and grids flattened
    frequency-fastest (the reference's row order).  Mode "cloud" (3ST):
    ``cloud_classifier``; mode "replace" (CNN_temp): ``grid_classifier(
    chunks [Nb, Ntemp, bins])`` on the chunks with the unkept bins
    zeroed."""
    if mode not in ("cloud", "replace"):
        raise ValueError(f"mode must be 'cloud' or 'replace', got {mode!r}")
    device, waves, lengths, labels = _inputs(device, waves, lengths, labels)
    n_total = Nfft * Ntemp // 2
    list_K = (default_list_K(n_total) if list_K is None
              else [int(k) for k in list_K])
    cfg = FeaturizeConfig(fs=fsog, n_fft=Nfft, top_db=tDb, trim=True)
    flat, valid, clabels = _temporal_rows(
        *_featurize(_kept(waves, lengths, cfg), cfg), labels, Ntemp)
    farr = freq_coords(flat.shape[-1], fsog, device=device)
    tarr = time_coords(Ntemp, Nfft, fsog, hf, device=device)
    R = int(nruns)

    def mb_counts(flat_mb, labels_mb, gen, Ks):
        vals = flat_mb.reshape(flat_mb.shape[0], -1)
        if mode == "cloud":
            return _prefix_mask_counts(
                cloud_classifier, grid_cloud(flat_mb, farr, tarr), vals,
                labels_mb, None, gen, Ks, R)
        return _prefix_mask_counts(
            lambda fl, keep: grid_classifier(
                torch.where(keep.reshape(fl.shape), fl, 0.0)),
            flat_mb, vals, labels_mb, None, gen, Ks, R)

    return _run_masked_sweep(mb_counts, [flat[valid]], clabels[valid], seed,
                             list_K, _MB_CHUNKS, R)


# ---------------------------------------------------------------------------
# model → classifier adapters (the model carries its weights)
# ---------------------------------------------------------------------------

def make_fst_frame_classifier(model):
    """frames ``[Nb, bins]`` + farr → FST logits (``ESC_pc``,
    ``Code/dataset.py:50-54``)."""
    def fn(frames, farr):
        return model(frame_cloud(frames, farr))
    return fn


def make_fb_frame_classifier(model):
    """frames ``[Nb, bins]`` → FB logits (``ESC_baseline``,
    ``Code/dataset.py:27``); ``farr`` is unused, kept for expt 1's
    signature.  The model is expected in eval mode (no dropout)."""
    def fn(frames, farr=None):
        return model(frames)
    return fn


def make_cnn_chunk_classifier(model):
    """chunks ``[Nb, Ntemp, bins]`` → CNN_temp logits
    (``ESC_baseline_temporal``); the coordinates are unused."""
    def fn(chunks, farr=None, tarr=None):
        return model(chunks)
    return fn


def make_3st_chunk_classifier(model):
    """chunks ``[Nb, Ntemp, bins]`` + coordinates → 3ST logits
    (``ESC_pc_temp``)."""
    def fn(chunks, farr, tarr):
        return model(grid_cloud(chunks, farr, tarr))
    return fn


def make_cloud_classifier(model):
    """points ``[Nb, n, d]`` (+ a key mask) → logits: the expt-2 engine
    passes the mask, so unselected points never enter the attention."""
    def fn(points, mask=None):
        return model(points, mask)
    return fn
