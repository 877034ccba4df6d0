"""The paper's evaluation sweeps (counterpart of
``pcaudio/eval/experiments.py``) for its four models.

The reference's eval scripts (``Code/pceval.py`` for FST,
``Code/baseline_eval.py`` for FB, ``Code/pc_temp3d_eval.py`` for 3ST,
``Code/baseline_temp_eval.py`` for CNN_temp, ``Code/rebut_expts.py`` for
3ST's importance sampling) re-run the classifier under
shifted conditions.  The emitted dicts serialize to exactly the reference's
``Code/paper_plots/*.json`` schemas:

  expt1:  ``{"data": {Fs: [acc per N]}, "list_Fs": [...], "list_N": [...]}``
  expt2:  ``{"data": {K: [mean, var]}, "list_K": [...]}``
  rebut:  ``{"data": {winF: {K: [mean, var]}}, "list_K": [...]}``

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

Expt 2 is a rank mask over the cloud in original point order: ``rank <
K`` where ``rank`` is a point's place in a stable descending sort of its
log-magnitude (maxK; ties to the lower index, as ``lax.top_k``) or of
uniform noise (randK: sampling without replacement).  One set of ranks
serves every K.  The cloud models run each mask on its kept points alone:
every row keeps exactly min(K, n) points, so the engine gathers them,
``[rows, min(K, n), d]`` in ascending point order, and runs the model with
no key mask.  A dropped point only ever enters the ST as a masked key
(MAB0, the PMA) or as a row of a row-wise layer (MAB1, the rFFs, every
Linear) that feeds such keys, so this is the masked forward over the full
cloud, the GEMMs' rounding order aside.  The random draws come from a
``torch.Generator`` seeded from ``seed`` and the microbatch index, so they
cannot match ``jax.random``'s bit for bit; the maxK counts are
deterministic.

Under a ``torch.profiler`` the expt-2 sweeps record spans
(``utils/profiling.py``): ``expt2.call`` over a call, in it
``expt2.featurize`` (the clips to valid rows, and each microbatch's
clouds), ``expt2.microbatch``, ``expt2.ranks`` (the random draws and the
ranks), ``expt2.forward`` (a masked forward and its hits) and
``expt2.results`` (the counts to the host, the dicts); and they count the
points each mask keeps (``expt2.points_kept``) against the points the
cloud classifier runs (``expt2.points_run``): equal since the cloud models
run the kept points alone; and the points of the forwards the classifier
serves by replaying a CUDA graph (``expt2.points_replayed``,
:func:`make_cloud_classifier`).

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
from pcaudio_torch.ops.kernels.mha import fused_mha_fwd
from pcaudio_torch.ops.subsample import importance_heatmap, topk_stable
from pcaudio_torch.utils.profiling import count, span

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


def _temporal_test_rows(waves, lengths, labels, *, fsog, Nfft, Ntemp, hf,
                        tDb, device):
    """The valid test chunks ``[Nc, Ntemp, bins]`` at the full rate and
    ``Nfft``, their labels and the grid's coordinates: the set-up of the
    temporal expt 2 and of the rebuttal sweep (the JAX
    ``_temporal_test_chunks``)."""
    cfg = FeaturizeConfig(fs=fsog, n_fft=Nfft, top_db=tDb, trim=True)
    flat, valid, clabels = _temporal_rows(
        *_featurize(_kept(waves, lengths, cfg), cfg), labels, Ntemp)
    return (flat[valid], clabels[valid],
            freq_coords(flat.shape[-1], fsog, device=device),
            time_coords(Ntemp, Nfft, fsog, hf, device=device))


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
    """``rank[..., i]`` = place of element ``i`` in the order of
    :func:`~pcaudio_torch.ops.subsample.topk_stable` over the last axis,
    so ``rank < K`` selects exactly ``jax.lax.top_k(x, K)``'s elements
    (ties to the lower index, -0.0 tying with 0.0)."""
    _, order = topk_stable(x, x.shape[-1])
    return _inverse(order)


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """The inverse of the permutations ``perm [..., n]`` of the last axis:
    a rank set's order (point ``order[..., j]`` has rank j), or an order's
    ranks."""
    iota = torch.arange(perm.shape[-1], device=perm.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(-1, perm, iota)


def _kept_points(x: torch.Tensor, order: torch.Tensor, K: int) -> torch.Tensor:
    """The points of ``x [rows, n, d]`` that ``rank < K`` keeps,
    ``[rows, min(K, n), d]``: each row's first ``K`` entries of ``order``
    (the ranks' inverse), sorted into point order, the order in which K4
    stages a key mask's valid keys, so the attention sums as under the
    mask.  Shapes come from ``K`` alone, so nothing waits for the
    device."""
    idx = order[:, :K].sort(dim=-1).values
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _mask_counts(classify: Callable, x: torch.Tensor, rmax: torch.Tensor,
                 rrand: torch.Tensor, labels: torch.Tensor,
                 valid: Optional[torch.Tensor], list_K: Sequence[int],
                 x_rand: Optional[torch.Tensor] = None, replace: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Correct predictions for each K of ``list_K``, keeping ``rmax < K``
    (maxK) and each of the ``R`` rank sets ``rrand [R, ...] < K`` (randK),
    the randK masks over ``x_rand [R, ...]`` where given (run r's own
    inputs), else over ``x``.

    The cloud models' form (``replace`` False): ``classify(points [rows,
    min(K, n), d]) -> logits`` on each row's kept points of ``x [rows, n,
    d]`` (:func:`_kept_points`).  Mode "replace": ``classify(x, keep [rows,
    n] bool) -> logits`` on the whole input.  Returns ``(counts_max [nK],
    counts_rand [nK, R])``, int64 on ``x``'s device."""
    R = rrand.shape[0]
    cmax = torch.zeros(len(list_K), dtype=torch.int64, device=x.device)
    crand = torch.zeros(len(list_K), R, dtype=torch.int64, device=x.device)
    rows, n = rmax.shape[0], rmax.shape[-1]
    if replace:
        def forward(xr, rank, K):
            return classify(xr, rank < K)
        smax, srand = rmax, rrand
    else:
        def forward(xr, order, K):
            return classify(_kept_points(xr, order, K))
        smax, srand = _inverse(rmax), _inverse(rrand)
    for j, K in enumerate(list_K):
        with span("expt2.forward"):
            count("expt2.points_kept", rows * min(K, n))
            cmax[j] = _hits(forward(x, smax, K), labels, valid)
        for r in range(R):
            xr = x if x_rand is None else x_rand[r]
            with span("expt2.forward"):
                count("expt2.points_kept", rows * min(K, n))
                crand[j, r] = _hits(forward(xr, srand[r], K), labels, valid)
    return cmax, crand


def _prefix_mask_counts(classify: Callable, x: torch.Tensor,
                        rank_src: torch.Tensor, labels: torch.Tensor,
                        valid: Optional[torch.Tensor], gen: torch.Generator,
                        list_K: Sequence[int], R: int, replace: bool = False):
    """The K sweep of one microbatch: maxK ranks from ``rank_src [..., n]``,
    randK ranks from ``R`` draws of uniform noise from ``gen`` (ranking the
    noise samples without replacement), then :func:`_mask_counts`."""
    with span("expt2.ranks"):
        noise = torch.rand((R,) + tuple(rank_src.shape), generator=gen,
                           device=rank_src.device)
        rmax, rrand = _ranks_desc(rank_src), _ranks_desc(noise)
    return _mask_counts(classify, x, rmax, rrand, labels, valid, list_K,
                        replace=replace)


def _microbatch_generator(seed, mb_index: int,
                          device: torch.device) -> torch.Generator:
    """The generator of one microbatch: ``seed`` (an int, or a tuple of
    ints such as ``(seed, winF)``) and the microbatch index, mixed by
    ``np.random.SeedSequence``."""
    words = list(seed) if isinstance(seed, tuple) else [seed]
    state = np.random.SeedSequence(words + [mb_index]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _run_masked_sweep(mb_counts: Callable, arrays: Sequence[torch.Tensor],
                      labels: torch.Tensor, seed,
                      list_K: Sequence[int], mb: int, R: int):
    """The microbatch loop of a K sweep over rows that are all valid: calls
    ``mb_counts(*slices, labels_mb, gen, list_K)`` on axis-0 slices of
    ``arrays`` of ``mb`` rows, with a generator per microbatch
    (:func:`_microbatch_generator` of ``seed``), sums the counts on the
    device, and returns the reference-schema dicts
    ``(randK {"data": {K: [mean, var]}}, maxK {"data": {K: [acc, 0]}})``."""
    n = labels.shape[0]
    cmax = torch.zeros(len(list_K), dtype=torch.int64, device=labels.device)
    crand = torch.zeros(len(list_K), R, dtype=torch.int64, device=labels.device)
    for mb_i, i in enumerate(range(0, n, mb)):
        with span("expt2.microbatch"):
            a, b = mb_counts(*(t[i: i + mb] for t in arrays), labels[i: i + mb],
                             _microbatch_generator(seed, mb_i, labels.device),
                             list_K)
            cmax += a
            crand += b
    with span("expt2.results"):
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

    Mode "cloud" (FST): ``cloud_classifier(points [Nb, min(K, n), 2]) ->
    logits``, each K and run on the kept points of the microbatch's clouds
    (the engine note above).  Mode "replace" (FB): ``frame_classifier(frames
    [Nb, bins], farr)`` on the frames with the unkept bins zeroed, the kept
    ones chosen by the same ranks."""
    if mode not in ("cloud", "replace"):
        raise ValueError(f"mode must be 'cloud' or 'replace', got {mode!r}")
    with span("expt2.call"):
        device, waves, lengths, labels = _inputs(device, waves, lengths, labels)
        list_K = (default_list_K(Nfft // 2) if list_K is None
                  else [int(k) for k in list_K])
        cfg = FeaturizeConfig(fs=fsog, n_fft=Nfft, top_db=tDb, trim=True)
        with span("expt2.featurize"):
            frames, valid, flabels = _valid_frames(
                *_featurize(_kept(waves, lengths, cfg), cfg), labels)
            farr = freq_coords(frames.shape[-1], fsog, device=device)
            frames, flabels = frames[valid], flabels[valid]
        R = int(nruns)

        def mb_counts(frames_mb, labels_mb, gen, Ks):
            if mode == "cloud":
                with span("expt2.featurize"):
                    clouds = frame_cloud(frames_mb, farr)
                return _prefix_mask_counts(cloud_classifier, clouds, frames_mb,
                                           labels_mb, None, gen, Ks, R)
            return _prefix_mask_counts(
                lambda fr, keep: frame_classifier(torch.where(keep, fr, 0.0), farr),
                frames_mb, frames_mb, labels_mb, None, gen, Ks, R, replace=True)

        return _run_masked_sweep(mb_counts, [frames], flabels, seed,
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
    ``cloud_classifier(points [Nb, min(K, n), 3])`` on the kept points;
    mode "replace" (CNN_temp): ``grid_classifier(chunks [Nb, Ntemp,
    bins])`` on the chunks with the unkept bins zeroed."""
    if mode not in ("cloud", "replace"):
        raise ValueError(f"mode must be 'cloud' or 'replace', got {mode!r}")
    with span("expt2.call"):
        device, waves, lengths, labels = _inputs(device, waves, lengths, labels)
        n_total = Nfft * Ntemp // 2
        list_K = (default_list_K(n_total) if list_K is None
                  else [int(k) for k in list_K])
        with span("expt2.featurize"):
            rows, row_labels, farr, tarr = _temporal_test_rows(
                waves, lengths, labels, fsog=fsog, Nfft=Nfft, Ntemp=Ntemp, hf=hf,
                tDb=tDb, device=device)
        R = int(nruns)

        def mb_counts(flat_mb, labels_mb, gen, Ks):
            vals = flat_mb.reshape(flat_mb.shape[0], -1)
            if mode == "cloud":
                with span("expt2.featurize"):
                    clouds = grid_cloud(flat_mb, farr, tarr)
                return _prefix_mask_counts(cloud_classifier, clouds, vals,
                                           labels_mb, None, gen, Ks, R)
            return _prefix_mask_counts(
                lambda fl, keep: grid_classifier(
                    torch.where(keep.reshape(fl.shape), fl, 0.0)),
                flat_mb, vals, labels_mb, None, gen, Ks, R, replace=True)

        return _run_masked_sweep(mb_counts, [rows], row_labels, seed,
                                 list_K, _MB_CHUNKS, R)


@torch.no_grad()
def rebut_importance_expt(cloud_classifier: Callable, waves, lengths, labels,
                          *, fsog: int = 44100, Nfft: int = 1024,
                          Ntemp: int = 10, hf: float = 0.5, tDb: float = 60.0,
                          list_winF: Sequence[int] = (64,),
                          list_K: Optional[Sequence[int]] = None,
                          nruns: int = 1, seed: int = 0, device="cuda"):
    """The importance-sampling rebuttal experiment on 3ST
    (``Code/rebut_expts.py:55-148``), on the engine of
    :func:`temporal_expt2`.  Returns ``(randK_dict, maxK_dict)`` of schema
    ``{"data": {winF: {K: [mean, var]}}, "list_K": [...]}``.

    Per window width and microbatch, the chunks' heat-maps
    (:func:`~pcaudio_torch.ops.subsample.importance_heatmap`) are
    flattened frequency-major.  maxK (the heat's top K) is a rank mask over
    that flat heat applied to the frequency-fastest cloud rows as they are,
    the reference's index-space mismatch kept.  randK (multinomial with
    replacement) is not a subset: each of the ``nruns`` runs draws
    ``Nfft·Ntemp/2`` indices with probability heat / Σ heat, the clouds
    are gathered in draw order, duplicates and all, and each K keeps the
    first K draws (a prefix of i.i.d. draws is distributed as K draws).
    Every forward runs on its kept points alone, as in
    :func:`temporal_expt2`.
    Each (winF, microbatch) has its own generator, from ``(seed, winF)``
    and the microbatch index."""
    with span("expt2.call"):
        device, waves, lengths, labels = _inputs(device, waves, lengths, labels)
        n_total = Nfft * Ntemp // 2
        list_K = (default_list_K(n_total) if list_K is None
                  else [int(k) for k in list_K])
        with span("expt2.featurize"):
            rows, row_labels, farr, tarr = _temporal_test_rows(
                waves, lengths, labels, fsog=fsog, Nfft=Nfft, Ntemp=Ntemp, hf=hf,
                tDb=tDb, device=device)
        R = int(nruns)
        rand_out = {"data": {}, "list_K": list_K}
        max_out = {"data": {}, "list_K": list_K}
        for winF in list_winF:
            def mb_counts(flat_mb, labels_mb, gen, Ks, _w=int(winF)):
                with span("expt2.featurize"):
                    clouds = grid_cloud(flat_mb, farr, tarr)
                with span("expt2.ranks"):
                    heat = importance_heatmap(flat_mb, win_f=_w)
                    heat_flat = heat.transpose(-1, -2).reshape(heat.shape[0], -1)
                    B, n = heat_flat.shape
                    draws = torch.multinomial(heat_flat.repeat(R, 1), n,
                                              replacement=True,
                                              generator=gen).reshape(R, B, n)
                    drawn = torch.stack([clouds.gather(1, d[..., None].expand(B, n, 3))
                                         for d in draws])
                    pos = torch.arange(n, device=flat_mb.device).expand(R, B, n)
                    rmax = _ranks_desc(heat_flat)
                return _mask_counts(cloud_classifier, clouds, rmax, pos, labels_mb,
                                    None, Ks, x_rand=drawn)

            rnd_w, max_w = _run_masked_sweep(mb_counts, [rows], row_labels,
                                             (seed, int(winF)), list_K, _MB_CHUNKS, R)
            rand_out["data"][int(winF)] = rnd_w["data"]
            max_out["data"][int(winF)] = max_w["data"]
        return rand_out, max_out


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


def _large_reserved(device) -> int:
    """Bytes the caching allocator holds on ``device`` in blocks of 1 MB
    and more, every pool together."""
    return torch.cuda.memory_stats(device)["reserved_bytes.large_pool.current"]


class _ForwardGraph:
    """``model``'s forward at the shape of ``static_input``, captured once in
    a CUDA graph into the memory pool ``pool`` on stream ``stream``.  A call
    copies the points into the static input, replays the graph on the
    current stream and returns a clone of its static output: the next
    replay overwrites that output, and callers keep the logits of earlier
    calls.  ``arena`` bytes, taken and freed before the forward, leave the
    pool one free block that this and later captures carve their
    intermediates from; ``grew`` is what the forward added to the pool."""

    def __init__(self, model, static_input, pool, stream, arena: int):
        self.input = static_input
        device = static_input.device
        self.graph = torch.cuda.CUDAGraph()
        before = fused_mha_fwd.launches
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            torch.empty(arena, dtype=torch.uint8, device=device)
            held = _large_reserved(device)
            self.output = model(self.input)
            self.grew = _large_reserved(device) - held
        # a capture runs nothing: its K4 launches count at each replay
        self.k4_launches = fused_mha_fwd.launches - before
        fused_mha_fwd.launches = before

    def __call__(self, points):
        self.input.copy_(points)
        self.graph.replay()
        fused_mha_fwd.launches += self.k4_launches
        return self.output.clone()


class _DeviceGraphs:
    """One device's forward graphs, one an input shape, in one memory pool
    and captured on one side stream.

    Replays run one at a time on the caller's stream, so every capture may
    reuse the memory of the others' intermediates; but a pool's free
    blocks serve only requests that fit them, and the sweeps' shapes arrive
    smallest first (K rises), so without more each capture would add its
    own intermediates to the pool.  So the captures carve theirs from one
    free arena, and a shape whose forward outgrows it starts a new pool
    with an arena twice the old arena and the growth together, and
    captures every shape there again: the pool stays within a few times
    the largest forward's intermediates, for a few captures more than one
    a shape."""

    def __init__(self, model, device):
        self.model = model
        self.stream = torch.cuda.Stream(device)
        self.graphs: Dict[tuple, _ForwardGraph] = {}
        self.pool, self.arena = torch.cuda.graph_pool_handle(), 0

    def __call__(self, key, points):
        graph = self.graphs.get(key)
        if graph is None:
            graph = self._add(key, points)
        return graph(points)

    def _add(self, key, points):
        static = points.clone()
        # PyTorch's recipe: an eager forward on the capture's stream first
        # (cuBLAS handle and workspace, the kernels' first-launch set-up)
        current = torch.cuda.current_stream(points.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.model(static)
        current.wait_stream(self.stream)
        graph = self.graphs[key] = _ForwardGraph(self.model, static, self.pool,
                                                 self.stream, 0)
        if graph.grew:
            arena = 2 * (self.arena + graph.grew)
            del graph
            inputs = [(k, g.input) for k, g in self.graphs.items()]
            # the old graphs go, so the next capture frees their pool
            self.graphs.clear()
            self.pool, self.arena = torch.cuda.graph_pool_handle(), arena
            for k, x in inputs:
                self.graphs[k] = _ForwardGraph(self.model, x, self.pool, self.stream,
                                               arena)
                arena = 0
        return self.graphs[key]


def make_cloud_classifier(model):
    """points ``[Nb, n, d]`` (+ an optional key mask) → logits.  The expt-2
    engine hands it each mask's kept points alone, ``n = min(K, n_cloud)``,
    with no mask.  Counts the points handed to the model
    (``expt2.points_run``).

    Where a replay is the same computation (CUDA points, no mask, no
    gradient), each input shape is captured once in a CUDA graph
    (:class:`_DeviceGraphs`) and every call replays it, so the host
    launches one graph where the eager forward launches each kernel: such
    calls count their points in ``expt2.points_replayed`` (0 for any other
    call, which runs the model eagerly)."""
    devices: Dict[torch.device, _DeviceGraphs] = {}

    def fn(points, mask=None):
        n = points.shape[0] * points.shape[1]
        replay = points.is_cuda and mask is None and not torch.is_grad_enabled()
        count("expt2.points_run", n)
        count("expt2.points_replayed", n if replay else 0)
        if not replay:
            return model(points, mask)
        graphs = devices.get(points.device)
        if graphs is None:
            graphs = devices[points.device] = _DeviceGraphs(model, points.device)
        # the GEMMs' precision is fixed when a graph is captured
        return graphs((tuple(points.shape), points.dtype,
                       torch.backends.cuda.matmul.allow_tf32), points)
    return fn
