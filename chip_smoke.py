"""Smoke run of the PyTorch / CUDA port (pcaudio_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Each phase's start is logged in seconds of script time (``[phase]``).

0. prints the card (name, power limit), torch and CUDA versions, and turns
   TF32 off for the plain references;
1. builds the kernels from pcaudio_torch/csrc (one nvcc per source, sm_90a;
   each source's compile time is logged), while processes of their own
   write phase 6's corpus and phase 9's WAV files, run phase 12's training
   runs on the card (no kernel is on their path; phase 4 waits for them)
   and compute phase 12's CPU gradients;
2. holds each kernel against its plain PyTorch version on the card at the
   serving path's shapes (featurize B=64 x 5 s clips; select on that grid, on
   a tie-heavy grid, at K 512 and 5120, on a grid with -0.0 entries, at K 1
   and K = Nt·F on a tie-heavy grid and on one chunk; the ST on the 64*43
   clouds, at K 1, 17, 128, 256 and 1025 with din 2 and 3, f32 and bf16
   points, no, ragged and all-masked masks, also against the f32 ST, and
   with the trained FST checkpoint on 1025-point ragged-masked 2-D clouds;
   K1's scratch form at K 1281, 2048 and 5120, with and without a ragged
   mask);
3. serves three requests (64, 17 and 100 ragged clips) through
   AudioClassifier with a full-width 3ST made from a seed and the bench's
   pipeline config, checks that each kernel was launched, that the logits
   are finite and that the labels agree with the plain path on the card;
   then the same requests through the "xla" featurize path (the JAX
   package's default) at top-K 128 and through full-grid serving (top_k
   None, 5,120-point clouds, K1's scratch form) on both featurize paths,
   each path's kernel counts read from 0, held against the fused path
   tie-aware, and in the f32 "highest" form (chunks with the same winning
   set on both paths: chunk logits within 1e-4);
4. times each kernel and its plain version, and the end-to-end path, at the
   bench shape (B=1024 clips of 5 s, 44,032 chunk clouds); times K3 a second
   way, on ragged traffic (synthetic clips of random lengths with trimmed
   lead-ins, checked against its plain version there too), prints the
   device time of each of K3's two launches on both batches, K2 at K 256
   and 5120 and on the f32 noise, ragged and tie-heavy grids (each held
   against its plain version there first), K1's time split
   by its three passes (launches cut after each), K1 at 256 points a
   cloud, K1's scratch form on one 64-clip batch of full grids (2,752
   clouds of 5,120 points) beside its plain version, the serving path's
   device time by kernel and the device's idle share
   (``torch.profiler``), and the e2e time of the xla featurize path beside
   the fused one and of full-grid serving;
5. holds K4 (the trainable attention, forward and backward) against its
   plain pair at the FST recipe's attends (B=128: 64 x 1025, 1025 x 64,
   1 x 1025 queries x keys), the 3ST recipe's (B=16, 5120 points, the
   forward's keys split over blocks), on ragged masks with an all-masked
   sample, on expt 2's rank masks at the FST attends (K 1, 501, 1025) and
   at 8 x randn's magnitude;
6. trains through ``pcaudio_torch.cli train`` on a generated synthetic ESC-10
   corpus (cut to CLIPS_PER_CLASS clips per class): one epoch of the FST
   recipe at full width (dim 64, 64 inducing points, 8 heads, batch 128
   frames of 1025 points), checking finite, falling losses, that K4 ran, and
   one batch's loss and gradients against the plain path; then 20 steps of
   the 3ST recipe at full width (batch 16 chunks of 5120 points), whose saved
   checkpoint AudioClassifier.from_reference_checkpoint loads and serves
   through K1-K3 at its default top_k (256 points a cloud);
7. times K4 and its plain pair at the FST attends (with their bounds: the
   backward's bytes, 3xTF32 products and exps printed as parts), K4's
   backward at the 3ST attends (B=16, the large side split), K4's forward
   at the eval shape (one expt-2 forward: B=1024 FST frames, rank masks at
   K 501), and the FST and 3ST recipe steps (forward + backward + Adam) on
   the kernel and the plain path, then profiles each kernel-path step
   (device ms by kernel, the idle share; K4's backward by BWD_KERNELS, and
   none of the SIMT pair's kernels at these shapes); then ``remat``: the
   3ST step from the trained weights with the whole forward checkpointed
   (the JAX step's form) and with each ISAB and the PMA checkpointed, held
   against the plain step (loss to 1e-6, gradients within 1e-4 of their
   largest entry, K4's forward launched twice as often, its backward as
   often), each step's peak device memory and the memory held when its
   forward returns (the blocks' peak must be lower than the plain step's,
   and both remat forms must hold less after the forward), and the three
   steps' times; and the FB step, whose dropout draws from the state's
   generator, with and without remat: equal loss, gradients and
   generator state;
8. runs the probes (``pcaudio_torch.probes``) at their TPU scripts' shapes:
   the K1 family (the batched dot, int8 vs bf16 tensor-core products, the
   int8 attend, 64- vs 128-wide chains, K1 relaunched bare / with weights
   repacked / through its wrapper) and the K3 family (int16 waves, the
   frame -> chunk relayout, K3's DFT as a bf16 tensor-core product at G
   clips a block, and with each clip's rows shifted by its trim start),
   holding each probe kernel against its plain version (the integer
   products and sums exactly, the DFT within a bound derived per element)
   and printing each probe's answer beside the card's name and power limit;
   then the redesigned probe kernels (the wgmma windowed GEMM of P1 and
   P2, the v6 attend of P3, the bf16 chain of P4a and the DFT of P8 and
   P9; the tiled int16 gram of P6a) beside their earlier design
   (pcaudio_torch/probes/earlier/, built while phase 1 builds) at every
   P1, P2a-c, P3, P4a, P6a shape, P8 form and P9 variant in this process
   (plain, old, new, new, old, plain, the library call; TFLOP/s and % of
   peak; P4a held exactly at the signed permutation), ptxas' registers
   and spills for the wgmma kernels, and the HGMMA / IGMMA count of their
   SASS (every instantiation must hold one; cuobjdump reads it in a
   process of its own from the end of phase 1 on);
9. serves WAV files (the ingest probe's corpus: 2,048 PCM16 files of 5 s,
   written by a process of its own during phase 1; batch 512) through ``AudioClassifier.classify_paths``: the native ring
   with pinned slots and a copy stream, K3-K2-K1 on the card; checks that
   int16 staging gives the f32 staging's logits bit for bit, that both equal
   ``logits`` on the clips decoded in memory, also for 12 batches of 64
   through the ring's 6 slots, then runs the probe's timings
   (``pcaudio_torch.probes.ingest``: decode-only and end-to-end clips/s,
   H2D and compute ms a batch, the idle share, request latency p50/p99);
10. runs the paper's evaluation on the card on the synthetic ESC-10 corpus
   at its full 40 clips per class (written by a process of its own while
   phase 8 runs; phase 10 waits for it), classifies the FST recipe's
   17,280 test clouds with the trained FST checkpoint
   (artifacts/roundtrip/FST_roundtrip_net.pth) three ways (K4, K1 and the
   f32 plain ST; the f32 accuracy must round to the 0.9828 the JAX package
   measured, and K4 and K1 must agree with it tie-aware), then runs
   ``pcaudio_torch.cli eval --experiments expt1 expt2`` on that checkpoint
   at the default lists (4 rates x 13 windows; 21 K x (1 + 10 runs))
   through K4 and holds each file against the JAX package's results
   (artifacts/roundtrip/FST_*.json: the same keys and lists, every expt 1
   and maxK cell and every randK mean within 0.01), times each experiment,
   counts K4's launches and profiles one expt-2 microbatch for K4's share
   of the device time; then runs a seeded full-width 3ST's expt 1 and expt 2
   (8 clips, K 1, 2561 and 5120, 2 runs) on both engines, whose logits
   must agree tie-aware; then ``cli eval --experiments rebut`` (the
   importance-sampling sweep) on a cut of the corpus with a seeded 3ST at
   the recipe's width through K4, its files checked by schema and range,
   and its maxK and randK cells at six K within 0.01 of the card's plain
   engine on the same draws;
11. runs the paper's two baselines, FB and CNN_temp, which no kernel serves
   (each kernel's launches over this path are printed): on phase 6's corpus
   ``cli train FB`` and ``cli train CNNTemp`` for one epoch at full width
   on the card (every step loss finite), one batch's loss and gradients on
   the card against the CPU with the recipe's seeded weights and dropout
   off (within 1e-4 of the gradient vector's largest entry), and each
   recipe's step time (CUDA events, 20 steps); then on phase 10's corpus
   ``cli eval`` of each, expt 1 (n_fft pinned) and expt 2 ("replace"), on
   the card from the ``.pth`` and ``reference_config.json`` training
   wrote: each file has the keys and lists of
   artifacts/cli_cycle/paper_plots/, every maxK spread is 0, and a cut
   (expt 1 at 44.1 kHz and two windows, maxK at three K) on 16 test clips
   (every fifth)
   agrees, card against CPU, within 0.01, with the trained and with the
   seeded weights; each sweep's wall time is printed, and each trained
   recipe's step is profiled by kernel at the end of the run.  No kernel
   may launch over this path;
12. the Set Transformer's own tasks at the JAX defaults' full widths, no
   kernel on their path: ModelNet40 (dim 256, 4 heads, 16 inducing points,
   1,000 points, batch 64, 40 classes) for one epoch (9 steps) and one
   eval on 640 / 128 synthetic clouds of 10,000 points through
   ``ModelNet40Fetcher.from_arrays``, every loss finite; MoG clustering
   (ST, dim 128, ln, K 4, B 10, N 100-500) for 300 steps, the last 50
   losses' mean below the first 50's, and its benchmark finite;
   ``cli max-regression --steps 500 --device cuda``, every MAE finite and
   the ST's and the max-pool DeepSet's under 1.0 (these runs are made
   beside the build); each task model's loss and gradients on one batch
   with its seeded weights, dropout off, on the card against the CPU
   (within 1e-4 of the gradient vector's largest entry); each task's step
   time (CUDA events) and ModelNet40's step profile (device ms, idle share,
   against its f32 product bound).  K1-K4 launches over these paths fail
   the run.

Beside each kernel's time at the main path's shapes it prints the least
time the card could take for that work (``bound_ms``: bytes over 3.35 TB/s
or operations over the type's peak) and, where one PyTorch call computes
the same function, that call's time (``library_ms``, a yardstick the port
never calls).

Any failure raises, so the exit code is non-zero.  The second-to-last line
of output is the kernels' JSON record, the last one the device record.
"""
import atexit
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from pcaudio_torch import cli, native
from pcaudio_torch.checkpoint import export_reference_pth, load_reference_pth
from pcaudio_torch.data import generate_esc_corpus, load_esc_split_waves, pad_batch
from pcaudio_torch.core.config import ExperimentConfig
from pcaudio_torch.eval import (
    TemporalPipelineConfig, extract_chunk_clouds, framewise_expt1,
    framewise_expt2, make_3st_chunk_classifier, make_cloud_classifier,
    make_chunk_logits, make_cnn_chunk_classifier, make_fb_frame_classifier,
    make_temporal_classifier, rebut_importance_expt, temporal_expt1,
    temporal_expt2)
from pcaudio_torch.eval.experiments import (
    _MB_CHUNKS, _MB_FRAMES, _prefix_mask_counts, _ranks_desc, default_list_K)
from pcaudio_torch.nn import ST
from pcaudio_torch.ops.kernels import _build
from pcaudio_torch.ops.kernels.featurize import (
    fused_chunk_mag2, fused_chunk_mag2_plain)
from pcaudio_torch.ops.kernels.fused_st import (
    _packed_weights, fused_st_forward, fused_st_forward_plain, launch_packed,
    launch_scratch, max_points)
from pcaudio_torch.ops.kernels.mha import (
    BWD_KERNELS, BWD_PAIR_KERNELS, FWD_KERNELS, _sm_count, bwd_plan, fused_mha_bwd,
    fused_mha_bwd_plain, fused_mha_fwd, fused_mha_plain)
from pcaudio_torch.ops.kernels.select import (
    exact_topk_chunks, exact_topk_chunks_plain)
from pcaudio_torch.probes import PROBES, ingest, probe_stages
from pcaudio_torch.probes.clips import FS, L, negzero_grid, ragged_waves, synthetic_waves
from pcaudio_torch.probes.k4_stages import bwd_parts, bwd_work
from pcaudio_torch.probes.st_launch import K1_TOL, st_exps, st_flops
from pcaudio_torch.probes.timing import (
    bound_ms, card, cuda_ms, describe, paired_ms, profile_device)
from pcaudio_torch.serve import AudioClassifier
from pcaudio_torch.train import (
    RECIPES, build_trainer, make_train_step, prepare_data,
    prepare_framewise_data, prepare_temporal_data)

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_B = 1024
TOP_K = 128
CFG = TemporalPipelineConfig(fs=FS, n_fft=1024, num_frames=10, top_k=TOP_K,
                             extraction="exact", featurize="fused",
                             stft_precision="default",
                             compute_dtype="bfloat16")
KERNELS = {  # wrapper, source, the TPU kernel's entry point it replaces
    "fused_chunk_mag2": (fused_chunk_mag2, "pcaudio_torch/csrc/featurize.cu",
                         "pcaudio/ops/kernels/featurize.py:285"),
    "exact_topk_chunks": (exact_topk_chunks, "pcaudio_torch/csrc/select.cu",
                          "pcaudio/ops/kernels/select.py:435"),
    "fused_st_forward": (fused_st_forward, "pcaudio_torch/csrc/fused_st.cu",
                         "pcaudio/ops/kernels/fused_st.py:554"),
    # K1's scratch form: clouds past the shared-memory form's 1,280 points
    # (the full 5,120-point grids), which the JAX fused ST takes at any size
    "fused_st_scratch": (launch_scratch, "pcaudio_torch/csrc/fused_st_scratch.cu",
                         "pcaudio/ops/kernels/fused_st.py:554"),
    "fused_mha_fwd": (fused_mha_fwd, "pcaudio_torch/csrc/mha.cu",
                      "pcaudio/ops/kernels/mha.py:377"),
    "fused_mha_bwd": (fused_mha_bwd, "pcaudio_torch/csrc/mha.cu",
                      "pcaudio/ops/kernels/mha.py:377"),
}
SERVE_KERNELS = ("fused_chunk_mag2", "exact_topk_chunks", "fused_st_forward")
# full-grid serving (top_k=None) on each featurize path: K3 on the fused
# path only, no K2, K1 in its scratch form
FULL_GRID_KERNELS = {"fused": ("fused_chunk_mag2", "fused_st_scratch"),
                     "xla": ("fused_st_scratch",)}
TRAIN_KERNELS = ("fused_mha_fwd", "fused_mha_bwd")
# K4 at the recipes' attends, (queries, keys), dv 64 in 8 heads of 8; one
# FST step runs MAB0 and MAB1 twice (two ISABs) and PMA once
FST_ATTENDS = {"MAB0": (64, 1025), "MAB1": (1025, 64), "PMA": (1, 1025)}
ST3_ATTENDS = {"MAB0": (64, 5120), "MAB1": (5120, 64), "PMA": (1, 5120)}
FST_STEP_ATTENDS = {"MAB0": 2, "MAB1": 2, "PMA": 1}
HEADS, DV = 8, 64
K1_POINTS = (1, 17, 128, 256, 1025)   # phase 2's clouds for K1
K1_SCRATCH_POINTS = (1281, 2048, 5120)  # and for its scratch form
FULL_POINTS = 5120   # a full temporal grid: 10 frames x 512 bins
SERVE_F32_TOL = 1e-4  # f32 "highest" logits of the two featurize paths
# phase 10's rebuttal cut: its cells at these K, K4 against the plain engine
REBUT_K = default_list_K(5120)[::20]
# the JAX tests' bars for the bf16 fused ST (tests/test_fused_st.py), atol
# = rtol: against the JAX kernel's own reference, and against the f32 model
JAX_K1_TOL = 3e-2
ST_F32_TOL = 5e-2
# served logits against the plain path: bf16 serving sits about 5e-2 from
# f32 (docs/ACCURACY.md); the kernel and its plain version share the
# roundings, so they sit far closer
SERVE_DEV_TOL = 5e-2
N_FFT, HOP = 1024, 512
CLIPS_PER_CLASS = 8   # of the corpus' 40: about 100 FST steps per epoch
FST_PTH = os.path.join(ROOT, "artifacts", "roundtrip", "FST_roundtrip_net.pth")
SWEEP_TOL = 0.01      # |port - JAX package| of a sweep cell (phase 10)
ANCHOR_ACC = 0.9828   # the f32 ST on the 17,280 test clouds (roundtrip_report.json)
EVAL_3ST_CLIPS, EVAL_3ST_K, EVAL_3ST_RUNS = 8, [1, 2561, 5120], 2
INGEST_FILES, INGEST_BATCH = 2048, 512   # the ingest probe's shape
BASELINES = ("FB", "CNNTemp")
# phase 11's cut of each baseline sweep, card against CPU: expt 1 at
# the full rate and two windows (the training window and half of it; FB's
# 2048 and 1024), maxK at three K (first, middle, last of the list)
BASE_CPU_WINDOWS = {"FB": [2048, 1024], "CNNTemp": [1024, 512]}
BASE_GRAD_TOL = 1e-4  # card vs CPU: of the gradient vector's largest entry
BASE_CUT_STRIDE = 5  # that cut on every 5th test clip: 16 of 80, every class
# phase 12: ModelNet40's synthetic set (clouds of the h5 dump's 10,000
# points, down-sampled x10 to the default 1,000), the clustering run's steps
MN40_TRAIN, MN40_TEST, MN40_POINTS, MN40_CLASSES = 640, 128, 10000, 40
CLUSTER_STEPS = 300
TASK_GRAD_TOL = 1e-4  # card vs CPU: of the gradient vector's largest entry


WGMMA_KERNELS = ("window_gemm_kernel", "attend_kernel", "dft_mag2_kernel", "chain_kernel")
# instantiations that must issue HGMMA / IGMMA: the GEMM and the attend in
# bf16 and s8 (2 each), the DFT in its four row modes and stacked (5), the
# chain at d 64 and 128 (2)
WGMMA_INSTANCES = {"window_gemm_kernel": 2, "attend_kernel": 2, "dft_mag2_kernel": 5,
                   "chain_kernel": 2}


def wgmma_kernel_of(mangled):
    """The WGMMA_KERNELS entry a mangled kernel name is an instantiation of:
    matched with its length prefix (``12chain_kernel``), so that
    ``16exp_chain_kernel`` is not taken for ``chain_kernel``."""
    return next((k for k in WGMMA_KERNELS if f"{len(k)}{k}" in mangled), None)


def start_sass_dump(lib_path):
    """Start ``cuobjdump -sass`` of the built library in a process of its
    own, into a file (about 15 s on one core, 42 MB of text), so that it
    runs beside phases 2-7 and not in phase 8, which reads it; None where
    cuobjdump does not exist."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    work = tempfile.mkdtemp(prefix="pcaudio_sass_")
    atexit.register(shutil.rmtree, work, True)
    path = os.path.join(work, "sass.txt")
    with open(path, "w") as out:
        proc = subprocess.Popen([tool, "-sass", str(lib_path)], stdout=out,
                                stderr=subprocess.DEVNULL)
    atexit.register(proc.kill)
    return proc, path


def wgmma_report(sass_job):
    """Phase 8: ptxas' registers, shared memory and spills of the wgmma
    kernels (build.log), and, where cuobjdump exists, how many HGMMA /
    IGMMA instructions each one's SASS holds (``start_sass_dump``'s file);
    fails unless every instantiation of WGMMA_INSTANCES holds one."""
    lines, current = [], None
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            current = wgmma_kernel_of(line)
            if current:
                lines.append(f"ptxas {line.split(chr(39))[1][:90]}")
        elif current and ("registers" in line or "spill" in line or "C75" in line):
            lines.append(f"ptxas   {line.strip()[:160]}")
    if sass_job is None:
        return lines + ["cuobjdump: not found, SASS not read"]
    proc, path = sass_job
    proc.wait()
    with open(path) as f:
        sass = f.read()
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            fn = fn if wgmma_kernel_of(fn) else None
        elif fn and ("HGMMA" in line or "IGMMA" in line):
            c = counts.setdefault(fn, {"HGMMA": 0, "IGMMA": 0})
            c["HGMMA" if "HGMMA" in line else "IGMMA"] += 1
    for k, n in WGMMA_INSTANCES.items():
        have = [fn for fn in counts if wgmma_kernel_of(fn) == k]
        check(len(have) == n, f"SASS: {len(have)} of the {n} instantiations of {k} issue "
              f"HGMMA / IGMMA ({sorted(counts)})")
    return lines + [f"SASS {fn[:90]}: {c['HGMMA']} HGMMA, {c['IGMMA']} IGMMA"
                    for fn, c in sorted(counts.items())]


def log(msg):
    print(msg, flush=True)


T_START = time.perf_counter()


def phase(title):
    """Log a phase's start in seconds of script time."""
    log(f"[phase] {title}: starts at {time.perf_counter() - T_START:.1f} s")


def seeded_st(din, seed, dim=64, inds=64, heads=8):
    """An ST (full width unless told: 64 hidden, 64 inducing points, 8
    heads) with weights drawn from a numpy seed, U(±1/sqrt(fan_in))."""
    model = ST(dim_input=din, dim_output=10, num_inds=inds, dim_hidden=dim,
               num_heads=heads)
    rng = np.random.default_rng(seed)
    sd = {k: torch.from_numpy(rng.uniform(-1, 1, v.shape).astype(np.float32)
                              / np.sqrt(v.shape[-1]))
          for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    return model.cuda().eval()


def k3_check(g, gm, r, rm, dt, what):
    """K3 against its plain grid: equal masks, finite values, and |X|² on
    valid chunks within 1e-5 of the chunk's largest |X|² + rtol 1e-4 (f32
    summation order, the real-input FFT vs cuFFT), plus one bf16 step when
    stored in bf16.  Returns (max |err|, max |err| / chunk max)."""
    check(torch.equal(gm, rm), f"K3 {what}: chunk masks differ")
    check(bool(torch.isfinite(g.float()).all()), f"K3 {what}: non-finite")
    gv, rv = g.float()[rm], r.float()[rm]
    rtol = 1e-4 + (2.0 ** -7 if dt == torch.bfloat16 else 0.0)
    atol = 1e-5 * rv.amax(dim=(1, 2), keepdim=True)
    err = (gv - rv).abs()
    check(bool((err <= atol + rtol * rv.abs()).all()),
          f"K3 {what}: |X|² outside tolerance (max err {err.max():.3e})")
    return err.max().item(), (err / rv.amax(dim=(1, 2), keepdim=True)).max().item()


def k3_launch_ms(waves, lengths):
    """Device ms a call of K3's two launches (torch.profiler, 5 calls)."""
    per, _ = profile_device(
        lambda: fused_chunk_mag2(waves, lengths, out_dtype=torch.bfloat16), 5)
    return [sum(v for k, v in per.items() if name in k)
            for name in ("trim_bounds_kernel", "frames_mag2_kernel")]


def nbytes(*tensors):
    return float(sum(t.numel() * t.element_size() for t in tensors))


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def k4_err(got, ref, what):
    """K4's tolerance, f32 on both sides: |err| <= 1e-4·max|ref| +
    1e-4·|ref| (online softmax, __expf, another summation order)."""
    err = (got - ref).abs()
    bound = 1e-4 * ref.abs().max() + 1e-4 * ref.abs()
    check(bool((err <= bound).all()),
          f"{what}: |err| {err.max().item():.3e} outside 1e-4·max|ref| + "
          f"1e-4·|ref| (max |ref| {ref.abs().max().item():.3e})")
    return err.max().item()


def mha_inputs(B, N, M, gen, ragged=False, keep=None, mag=1.0):
    """randn q, k, v, g (times ``mag``); a ragged mask (a full and an
    all-masked sample) or expt 2's rank mask keeping ``keep`` keys."""
    dev = torch.device("cuda")
    q, k, v, g = (mag * torch.randn(B, r, DV, device=dev, generator=gen)
                  for r in (N, M, M, N))
    mask = None
    if ragged:
        counts = torch.randint(1, M + 1, (B,), device=dev, generator=gen)
        counts[0], counts[1] = M, 0      # a full and an all-masked sample
        mask = torch.arange(M, device=dev)[None, :] < counts[:, None]
    elif keep is not None:
        mask = _ranks_desc(torch.rand(B, M, device=dev, generator=gen)) < keep
    return q, k, v, mask, g


def k4_check(B, N, M, gen, ragged=False, keep=None, mag=1.0):
    """K4 forward and backward vs the plain pair; returns (fwd, bwd) max
    |err|."""
    q, k, v, mask, g = mha_inputs(B, N, M, gen, ragged, keep, mag)
    scale = 1.0 / DV ** 0.5
    out, lse = fused_mha_fwd(q, k, v, mask, HEADS, scale)
    grads = fused_mha_bwd(q, k, v, mask, out, lse, g, HEADS, scale)
    torch.cuda.synchronize()
    what = (f"K4 B={B} {N}x{M}{' ragged' if ragged else ''}"
            f"{f' rank mask K={keep}' if keep is not None else ''}"
            f"{f' x{mag:g}' if mag != 1.0 else ''}")
    fwd = k4_err(out, fused_mha_plain(q, k, v, mask, HEADS, scale),
                 f"{what} out")
    ref = fused_mha_bwd_plain(q, k, v, mask, g, HEADS, scale)
    if keep == 1:
        # one valid key a row: dq and dk are zero in exact arithmetic (a
        # softmax over one key is constant), so their rounding noise is
        # held against the three gradients' common scale, as phase 6 holds
        # the parameter gradients
        bwd = k4_err(torch.cat([x.flatten() for x in grads]),
                     torch.cat([x.flatten() for x in ref]), f"{what} dq, dk, dv")
    else:
        bwd = max(k4_err(a, r, f"{what} d{n}")
                  for a, r, n in zip(grads, ref, "qkv"))
    if ragged:
        check(not out[1].any() and not any(x[1].any() for x in grads),
              f"{what}: the all-masked sample must give zeros")
    return fwd, bwd


def k4_fwd_parts(exps, flops, nb):
    """The three times that bound K4's forward: exps on the SFU, the 3xTF32
    products (``flops`` counts all three passes) on the tensor cores, the
    bytes."""
    return (f"exps {bound_ms({'sfu': exps}, 0)[0]:.4f} ms, 3xTF32 products "
            f"{bound_ms({'tf32': flops}, 0)[0]:.4f} ms, bytes {bound_ms({}, nb)[0]:.4f} ms")


def k4_eval_time(gen, name_limit):
    """Phase 7: K4's forward at the eval shape, one expt-2 forward of the
    FST: B = 1024 frames, rank masks at K 501 on MAB0 and PMA (MAB1's keys
    are the 64 inducing summaries, unmasked); kernel vs plain vs SDPA with
    the mask, and its bound from the valid keys only."""
    B, keep = _MB_FRAMES, 501
    scale = 1.0 / DV ** 0.5
    ms, plain, lib = 0.0, 0.0, 0.0
    work = [0.0, 0.0, 0.0]
    for name, (N, M) in FST_ATTENDS.items():
        masked = M == 1025
        q, k, v, mask, _ = mha_inputs(B, N, M, gen, keep=keep if masked else None)
        out, _ = fused_mha_fwd(q, k, v, mask, HEADS, scale)
        k4_err(out, fused_mha_plain(q, k, v, mask, HEADS, scale), f"K4 eval {name}")
        n, valid = FST_STEP_ATTENDS[name], keep if masked else M
        work[0] += n * float(B) * HEADS * N * valid
        work[1] += n * 3 * 4.0 * B * N * valid * DV
        # q, out, lse, the valid K and V rows, the mask
        work[2] += n * (nbytes(q, out) + 4.0 * B * HEADS * N + 8.0 * B * valid * DV
                        + (B * M if masked else 0))
        t = paired_ms(lambda: fused_mha_fwd(q, k, v, mask, HEADS, scale),
                      lambda: fused_mha_plain(q, k, v, mask, HEADS, scale), 10, 3)
        heads = [x.view(B, -1, HEADS, DV // HEADS).transpose(1, 2) for x in (q, k, v)]
        am = None if mask is None else mask[:, None, None, :]
        lib_t = cuda_ms(lambda: F.scaled_dot_product_attention(
            *heads, attn_mask=am, scale=scale), 10)
        ms, plain, lib = ms + n * t[0], plain + n * t[1], lib + n * lib_t
        log(f"[time] K4 fwd at the eval shape, {name} B={B} {N}x{M}"
            f"{f' rank mask K={keep}' if masked else ''}: kernel {t[0]:.3f} ms, plain "
            f"{t[1]:.3f} ms, sdpa {lib_t:.3f} ms ({name_limit})")
        del q, k, v, mask, out, heads, am
        torch.cuda.empty_cache()
    b = bound_ms({"sfu": work[0], "tf32": work[1]}, work[2])
    log(f"[time] K4 fwd over one expt-2 forward's five attends (B={B}, rank masks "
        f"K={keep}): kernel {ms:.3f} ms, plain {plain:.3f} ms, sdpa {lib:.3f} ms, "
        f"bound {b[0]:.4f} ms by {b[1]} ({k4_fwd_parts(*work)}) ({name_limit})")


def k4_attend_times(q, k, v, out, lse, g, iters):
    """K4's forward and backward on one attend (no mask), each paired with
    its plain version, and F.scaled_dot_product_attention's forward and
    autograd backward over the same heads (a yardstick the port never
    calls): ``((fwd, plain), sdpa fwd, (bwd, plain), sdpa bwd)``."""
    B = q.shape[0]
    scale = 1.0 / DV ** 0.5
    heads = [x.view(B, -1, HEADS, DV // HEADS).transpose(1, 2) for x in (q, k, v, g)]
    lib_f = cuda_ms(lambda: F.scaled_dot_product_attention(*heads[:3], scale=scale), iters)
    leaves = [x.detach().requires_grad_() for x in heads[:3]]
    lib_out = F.scaled_dot_product_attention(*leaves, scale=scale)
    lib_b = cuda_ms(lambda: torch.autograd.grad(
        lib_out, leaves, heads[3], retain_graph=True), iters)
    fwd = paired_ms(lambda: fused_mha_fwd(q, k, v, None, HEADS, scale),
                    lambda: fused_mha_plain(q, k, v, None, HEADS, scale), iters, iters)
    bwd = paired_ms(lambda: fused_mha_bwd(q, k, v, None, out, lse, g, HEADS, scale),
                    lambda: fused_mha_bwd_plain(q, k, v, None, g, HEADS, scale),
                    iters, iters)
    return fwd, lib_f, bwd, lib_b


def k4_3st_bwd_time(gen, name_limit):
    """Phase 7: K4's backward at the 3ST step's attends (B = 16, the large
    side split over blocks), kernel vs plain vs SDPA's backward, and its
    bound."""
    B = 16
    scale = 1.0 / DV ** 0.5
    ms, plain, lib, work = 0.0, 0.0, 0.0, [0.0, 0.0, 0.0]
    for name, (N, M) in ST3_ATTENDS.items():
        q, k, v, _, g = mha_inputs(B, N, M, gen)
        out, lse = fused_mha_fwd(q, k, v, None, HEADS, scale)
        _, _, bwd, lib_b = k4_attend_times(q, k, v, out, lse, g, 10)
        n = FST_STEP_ATTENDS[name]
        ms, plain, lib = ms + n * bwd[0], plain + n * bwd[1], lib + n * lib_b
        w = bwd_work(B, N, M)
        work = [a + n * b for a, b in zip(work, w)]
        plan = bwd_plan(B, N, M, HEADS, _sm_count(0))
        log(f"[time] K4 bwd 3ST {name} B={B} {N}x{M} ({plan.kind}, {plan.splits} splits): "
            f"kernel {bwd[0]:.3f} ms, plain {bwd[1]:.3f} ms, sdpa {lib_b:.3f} ms, bound "
            f"{bound_ms({'sfu': w[0], 'tf32': w[1]}, w[2])[0]:.4f} ms ({name_limit})")
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()
    b = bound_ms({"sfu": work[0], "tf32": work[1]}, work[2])
    log(f"[time] K4 bwd over one 3ST step's five attends (B={B}): kernel {ms:.3f} ms, "
        f"plain {plain:.3f} ms, sdpa {lib:.3f} ms, bound {b[0]:.4f} ms by {b[1]} "
        f"({bwd_parts(*work)}) ({name_limit})")


def _named(per, names):
    return [k for k in per if any(f"{n}<" in k or f"{n}(" in k for n in names)]


def _short(name):
    """A profiler's kernel name without namespace and arguments."""
    return name.replace("(anonymous namespace)::", "").split("(")[0][-48:]


def step_profile(tag, step, name_limit):
    """Phase 7: one recipe step's device time by kernel and the idle share
    (torch.profiler over 5 steps); K4's backward found by BWD_KERNELS, and
    none of the SIMT pair's kernels at a recipe shape."""
    per, idle = profile_device(step, 5)
    total = sum(per.values())
    bwd, pair = _named(per, BWD_KERNELS), _named(per, BWD_PAIR_KERNELS)
    fwd = _named(per, FWD_KERNELS)
    check(bool(bwd) and not pair, f"{tag} step: K4's backward kernels in the profile "
          f"{bwd}, of which the SIMT pair's {pair} (none expected); its kernels: "
          f"{list(per)[:10]}")
    log(f"[time] {tag} step profile: device {total:.3f} ms a step, K4 bwd "
        f"{sum(per[k] for k in bwd):.3f} ms ({', '.join(_short(k) for k in bwd)}), "
        f"K4 fwd {sum(per[k] for k in fwd):.3f} ms, idle share {idle:.4f}; by kernel: "
        + "; ".join(f"{_short(k)} {v:.3f}" for k, v in list(per.items())[:10])
        + f" ({name_limit})")


def k1_check(got, ref, what, tol=None):
    """K1 against a reference: finite, of the same shape, |err| <= tol +
    tol·|ref| (K1_TOL against its plain version, which rounds to bf16 at the
    same places; ST_F32_TOL against the f32 ST).  Returns max |err|."""
    tol = K1_TOL if tol is None else tol
    check(got.shape == ref.shape, f"K1 {what}: shape {tuple(got.shape)} vs "
          f"{tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"K1 {what}: non-finite logits")
    err = (got - ref).abs()
    check(bool((err <= tol + tol * ref.abs()).all()),
          f"K1 {what}: max |err| {err.max().item():.3e} outside {tol} + "
          f"{tol}·|ref|")
    return err.max().item()


def k1_bound(points, model):
    """K1's bound on ``points``: the ST's products on bf16 tensor cores and
    its softmax exps on the SFU, or its bytes (points, weights, logits)."""
    n, k, din = points.shape
    return bound_ms({"bf16": float(n * st_flops(k, din, DV, 64, 10)),
                     "sfu": float(n * st_exps(k, 64, HEADS))},
                    nbytes(points, *model.parameters()) + 4.0 * n * 10)


def tie_aware_argmax(got, ref, tol=SERVE_DEV_TOL):
    """Rows whose reference top-2 gap is below twice the largest deviation
    are excused; every other row must agree; the deviation itself must be
    at most ``tol``, so that a large one cannot excuse every row.
    Returns (agree, decided, dev)."""
    dev = (got - ref).abs().max().item()
    check(dev <= tol, f"max logit deviation {dev:.3e} from the plain "
          f"path exceeds {tol}")
    top2 = ref.sort(dim=-1).values[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) >= 2 * dev
    agree = (got.argmax(-1) == ref.argmax(-1))
    check(bool(agree[decided].all()), f"argmax disagrees on a decided row "
          f"(max logit dev {dev:.3e})")
    return int(agree.sum()), int(decided.sum()), dev


def recipe_batch(tag, csv, audio, dev):
    """One batch of the recipe from its first test clips, on the card."""
    cfg = RECIPES[tag]()
    prep = prepare_framewise_data if tag == "FST" else prepare_temporal_data
    waves, lengths, labels = load_esc_split_waves(csv, audio, cfg.numpy_seed,
                                                  split="test")
    data = prep(waves[:8], lengths[:8], labels[:8], cfg, device=dev)
    n = cfg.batch_size
    check(len(data["labels"]) >= n, f"{tag}: fewer than {n} test clouds")
    return cfg, {"points": torch.from_numpy(data["points"][:n]).to(dev),
                 "labels": torch.from_numpy(data["labels"][:n]).long().to(dev)}


def train_phase(work, dev, corpus_job):
    """Phase 6 on the corpus ``corpus_job`` writes.  Returns the K4 launches
    of the FST training run, and per recipe the trained weights and one
    batch (phase 7 times their steps)."""
    csv, audio, waited = wait_corpus(corpus_job)
    log(f"[train] synthetic ESC-10 corpus: {CLIPS_PER_CLASS} clips per class "
        f"(cut from the corpus' 40 to keep the run short), written during "
        f"the build; waited {waited:.1f} s for it")
    fst_dir, st3_dir = os.path.join(work, "fst"), os.path.join(work, "3st")
    common = ["--esc-csv", csv, "--esc-audio", audio, "--epochs", "1",
              "--device", "cuda"]

    for k in TRAIN_KERNELS:
        KERNELS[k][0].launches = 0
    t0 = time.perf_counter()
    state, hist = cli.main(["train", "FST", "--out-dir", fst_dir, *common])
    torch.cuda.synchronize()
    launches = {k: KERNELS[k][0].launches for k in TRAIN_KERNELS}
    log(f"[train] FST launches: {launches}")
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched on the training path")
    losses = hist[0]["step_losses"]
    check(bool(np.isfinite(losses).all()), "FST: a step loss is not finite")
    tail = float(np.mean(losses[-10:]))
    check(tail < losses[0], f"FST: the last 10 steps' mean loss {tail:.4f} is "
          f"not below the first step's {losses[0]:.4f}")
    log(f"[train] FST full width, 1 epoch = {len(losses)} steps of 128 in "
        f"{time.perf_counter() - t0:.1f} s: first loss {losses[0]:.4f}, mean "
        f"of the last 10 {tail:.4f}, test accuracy "
        f"{hist[0]['test_accuracy']:.4f}")

    weights, batches = {}, {}
    weights["FST"] = {k: v.clone() for k, v in state.model.state_dict().items()}
    cfg, batch = batches["FST"] = recipe_batch("FST", csv, audio, dev)
    res = {}
    for fused in (True, False):
        state, apply_fn = build_trainer(cfg, dev, fused_attn=fused)
        model = state.model
        model.load_state_dict(weights["FST"])
        loss = torch.nn.functional.cross_entropy(apply_fn(batch),
                                                 batch["labels"])
        loss.backward()
        res[fused] = loss.item(), dict(model.named_parameters())
    rel = abs(res[True][0] - res[False][0]) / abs(res[False][0])
    check(rel <= 1e-4, f"FST batch loss: kernel {res[True][0]:.6f} vs plain "
          f"{res[False][0]:.6f}")
    # one bound for the whole gradient vector: the fc_k biases' gradients
    # are zero in exact arithmetic (a softmax ignores a shift shared by all
    # keys), so a bound relative to each tensor would judge rounding noise
    gerr = k4_err(torch.cat([p.grad.flatten() for p in res[True][1].values()]),
                  torch.cat([res[False][1][n].grad.flatten()
                             for n in res[True][1]]), "FST parameter grads")
    log(f"[train] one FST batch, kernel vs plain path: loss {res[True][0]:.6f} "
        f"vs {res[False][0]:.6f} (rel {rel:.2e}), parameter grads max |err| "
        f"{gerr:.3e}")

    t0 = time.perf_counter()
    state3, hist3 = cli.main(["train", "3ST", "--out-dir", st3_dir,
                              "--max-steps", "20", *common])
    losses3 = hist3[0]["step_losses"]
    check(len(losses3) == 20 and bool(np.isfinite(losses3).all()),
          f"3ST: {len(losses3)} steps, losses {losses3}")
    log(f"[train] 3ST full width, 20 steps of 16 x 5120 points in "
        f"{time.perf_counter() - t0:.1f} s: losses {losses3[0]:.4f} -> "
        f"{losses3[-1]:.4f}")
    weights["3ST"] = {k: v.clone() for k, v in state3.model.state_dict().items()}
    batches["3ST"] = recipe_batch("3ST", csv, audio, dev)

    clf = AudioClassifier.from_reference_checkpoint(
        os.path.join(st3_dir, "reference_config.json"),
        os.path.join(st3_dir, "3ST_net.pth"), batch_size=16, device="cuda")
    check(clf.pipeline.top_k == 256, f"the serving default top_k is "
          f"{clf.pipeline.top_k}, not 256")
    cfg3 = RECIPES["3ST"]()
    w3, n3, _ = load_esc_split_waves(csv, audio, cfg3.numpy_seed, split="test")
    clips = [w3[i, :n3[i]] for i in range(10)]
    for k in SERVE_KERNELS:
        KERNELS[k][0].launches = 0
    lg = clf.logits(clips)
    torch.cuda.synchronize()
    served = {k: KERNELS[k][0].launches for k in SERVE_KERNELS}
    for k, n in served.items():
        check(n > 0, f"{k} was not launched serving the trained 3ST")
    check(lg.shape == (10, 10) and bool(np.isfinite(lg).all()),
          f"served 3ST logits {lg.shape}")
    ref = AudioClassifier(model=clf.model, pipeline=clf.pipeline,
                          batch_size=16, device="cuda", plain=True).logits(clips)
    agree, decided, ldev = tie_aware_argmax(torch.from_numpy(lg),
                                            torch.from_numpy(ref))
    log(f"[train] the saved 3ST served from 3ST_net.pth with the default "
        f"top_k {clf.pipeline.top_k} through K1-K3 ({served}): labels {lg.argmax(-1).tolist()}, {agree}/10 agree with "
        f"the plain path ({decided} decided), max logit dev {ldev:.3e}")
    return {"launches": launches, "weights": weights, "batches": batches,
            "corpus": (csv, audio)}


def chunk_indices(points, F=512, Nt=10):
    """Flat frequency-fastest indices of f32 serving clouds from their
    affine (f, t) coordinates (the steps ``_affine_clouds`` uses)."""
    cf = 0.5 / (F - 1)
    ct = (0.5 * N_FFT / FS) * Nt / (Nt - 1)
    f = torch.round(points[..., 0] / cf).long()
    t = torch.round(points[..., 1] / ct).long()
    return t * F + f


def serve_paths_phase(model, requests, served, launches, name_limit):
    """Phase 3's second half: the same three requests through the "xla"
    featurize path (the JAX package's default) at top_k 128, and through
    full-grid serving (top_k=None: K1's scratch form) on both featurize
    paths, each path's kernel counts set to 0 just before it and read just
    after; each held against the fused path tie-aware in the bf16 serving
    form.  Then the f32 "highest" form on the first 6 clips of each
    request: where a chunk's winning set is the same on both paths, its
    logits (the f32 ST, plain attention) agree within SERVE_F32_TOL."""
    t0 = time.perf_counter()
    xla_128 = dataclasses.replace(CFG, featurize="xla")
    zero_counts()
    clf = AudioClassifier(model=model, pipeline=xla_128, batch_size=64,
                          buffer_len=L, device="cuda")
    got = [clf.logits(req) for req in requests]
    torch.cuda.synchronize()
    counts = kernel_counts()
    check(counts["fused_st_forward"] > 0 and counts["fused_st_scratch"] == 0
          and counts["fused_chunk_mag2"] == counts["exact_topk_chunks"] == 0,
          f"xla serving at top_k {TOP_K}: launches {counts}")
    for req, lg, ref in zip(requests, got, served):
        agree, decided, ldev = tie_aware_argmax(torch.from_numpy(lg),
                                                torch.from_numpy(ref))
        log(f"[serve] xla featurize, top_k {TOP_K}, {len(req)} clips: argmax "
            f"agrees with the fused path on {agree}/{len(req)} ({decided} "
            f"decided rows all agree), max logit dev {ldev:.3e}")
    full = {}
    launches["fused_st_scratch"] = 0
    for fz in ("fused", "xla"):
        cfg = dataclasses.replace(CFG, featurize=fz, top_k=None)
        clf = AudioClassifier(model=model, pipeline=cfg, batch_size=64,
                              buffer_len=L, device="cuda")
        zero_counts()
        full[fz] = [clf.logits(req) for req in requests]
        torch.cuda.synchronize()
        counts = kernel_counts()
        log(f"[serve] full grids (top_k=None, {FULL_POINTS} points a cloud), "
            f"{fz} featurize: launches {counts}")
        for k, n in counts.items():
            check((n > 0) == (k in FULL_GRID_KERNELS[fz]),
                  f"full-grid serving, {fz} featurize: {k} launched {n} times")
        launches["fused_st_scratch"] += counts["fused_st_scratch"]
        for lg in full[fz]:
            check(bool(np.isfinite(lg).all()), "full-grid logits not finite")
    for req, lx, lf in zip(requests, full["xla"], full["fused"]):
        agree, decided, ldev = tie_aware_argmax(torch.from_numpy(lx),
                                                torch.from_numpy(lf))
        log(f"[serve] full grids, {len(req)} clips: the xla path agrees with "
            f"the fused path on {agree}/{len(req)} ({decided} decided rows all "
            f"agree), max logit dev {ldev:.3e}")
    f32 = dataclasses.replace(CFG, stft_precision="highest",
                              compute_dtype="float32")
    for top_k in (TOP_K, None):
        same = total = 0
        dev = 0.0
        for req in requests:
            w, n = (torch.from_numpy(a).to("cuda") for a in pad_batch(req[:6], L))
            out = {}
            for fz in ("fused", "xla"):
                cfg = dataclasses.replace(f32, featurize=fz, top_k=top_k)
                cloud, cm = extract_chunk_clouds(w, n, cfg)
                valid = cm.reshape(-1)
                pts = cloud.points[valid]
                with torch.no_grad():
                    out[fz] = (model(pts, None), pts)
            (lf, pf), (lx, px) = out["fused"], out["xla"]
            if top_k is None:
                eq = torch.ones(len(pf), dtype=torch.bool, device=pf.device)
            else:
                eq = (chunk_indices(pf).sort(-1).values
                      == chunk_indices(px).sort(-1).values).all(-1)
            same, total = same + int(eq.sum()), total + len(eq)
            if bool(eq.any()):
                dev = max(dev, (lf[eq] - lx[eq]).abs().max().item())
        check(same * 12 >= total * 11, f"f32 top_k {top_k}: {same}/{total} "
              f"chunks with the same winning set on both paths")
        check(dev <= SERVE_F32_TOL, f"f32 top_k {top_k}: chunk logits "
              f"{dev:.3e} apart where the sets agree")
        log(f"[serve] f32 highest, top_k {top_k}: the same winning set on "
            f"both featurize paths in {same}/{total} valid chunks, their "
            f"chunk logits within {dev:.3e} (bar {SERVE_F32_TOL})")
    log(f"[serve] xla and full-grid paths: {time.perf_counter() - t0:.1f} s "
        f"({name_limit})")


def k1_scratch_time(model, waves, lengths, times, bounds, lib_ms, name_limit):
    """K1's scratch form on one serving batch of 64 clips of 5 s at
    top_k=None (2,752 clouds of 5,120 points), kernel, plain, kernel: the
    plain version in pieces of 344 clouds (8 clips), whose attention
    tensors fit; its bound by exps or products."""
    pts = extract_chunk_clouds(waves, lengths, dataclasses.replace(
        CFG, top_k=None))[0].points
    check(pts.shape[1] == FULL_POINTS, f"full grids of {pts.shape[1]} points")

    def plain():
        return torch.cat([fused_st_forward_plain(model, pts[i:i + 344], None)
                          for i in range(0, len(pts), 344)])
    before = launch_scratch.launches
    k0 = cuda_ms(lambda: fused_st_forward(model, pts, None), 3)
    p = cuda_ms(plain, 1)
    k1 = cuda_ms(lambda: fused_st_forward(model, pts, None), 3)
    n = launch_scratch.launches - before
    times["fused_st_scratch"] = ((k0 + k1) / 2, p)
    bounds["fused_st_scratch"] = k1_bound(pts, model)
    lib_ms["fused_st_scratch"] = None
    log(f"[time] K1 scratch form, {pts.shape[0]} clouds of {pts.shape[1]} points "
        f"(64 clips, top_k None): kernel {k0:.3f} / {k1:.3f} ms ({n} launches), "
        f"plain {p:.3f} ms, bound {bounds['fused_st_scratch'][0]:.3f} ms by "
        f"{bounds['fused_st_scratch'][1]} ({name_limit})")
    del pts
    torch.cuda.empty_cache()


def kernel_counts():
    return {k: w.launches for k, (w, _, _) in KERNELS.items()}


def zero_counts():
    for w, _, _ in KERNELS.values():
        w.launches = 0


def baselines_train_phase(corpus, out_dir, dev, name_limit):
    """Phase 11, its training half, on phase 6's corpus: ``cli train FB``
    and ``cli train CNNTemp`` for one epoch at full width on the card
    (every step loss finite, no kernel launched), one batch's loss and
    gradients on the card against the CPU with the recipe's seeded weights
    and dropout off, and each recipe's step time.  Returns each recipe's
    output directory."""
    csv, audio = corpus
    t_phase = time.perf_counter()
    dirs = {}
    for tag in BASELINES:
        cfg = RECIPES[tag]()
        d = dirs[tag] = os.path.join(out_dir, tag)
        zero_counts()
        t0 = time.perf_counter()
        state, hist = cli.main(["train", tag, "--out-dir", d, "--esc-csv", csv,
                                "--esc-audio", audio, "--epochs", "1",
                                "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: n for k, n in kernel_counts().items() if n}
        check(not counts, f"cli train {tag} launched kernels {counts}")
        losses = hist[0]["step_losses"]
        check(len(losses) > 0 and bool(np.isfinite(losses).all()),
              f"{tag}: step losses {losses}")
        check(next(state.model.parameters()).is_cuda, f"{tag} trained off the card")
        trained = state.model.state_dict()
        log(f"[base] {tag} full width (layers {cfg.layers}, dropout "
            f"{cfg.dropout_prob}), 1 epoch = {len(losses)} steps of "
            f"{cfg.batch_size} on the card in {wall:.1f} s: first loss "
            f"{losses[0]:.4f}, mean of the last 10 {np.mean(losses[-10:]):.4f}, "
            f"test accuracy {hist[0]['test_accuracy']:.4f}; no kernel launched")

        # one batch of the first test clips, dropout off, card against CPU at
        # the recipe's seeded weights (after one epoch FB's double softmax
        # saturates, its gradients near 1e-29: no scale to hold them to)
        waves, lengths, labels = load_esc_split_waves(csv, audio, cfg.numpy_seed,
                                                      split="test")
        data = prepare_data(waves[:8], lengths[:8], labels[:8], cfg, device=dev)
        n = cfg.batch_size
        check(len(data["labels"]) >= n, f"{tag}: fewer than {n} test inputs")
        x = torch.from_numpy(data["x"][:n])
        y = torch.from_numpy(data["labels"][:n]).long()
        seeded = build_trainer(cfg, "cpu")[0].model.state_dict()
        res = {}
        for where in ("cuda", "cpu"):
            model = cfg.build_model()
            model.load_state_dict(seeded)
            model = model.to(where).eval()
            loss = F.cross_entropy(model(x.to(where)), y.to(where))
            loss.backward()
            res[where] = loss.item(), torch.cat(
                [p.grad.flatten().cpu() for p in model.parameters()])
        (lg, gg), (lc, gc) = res["cuda"], res["cpu"]
        gscale = gc.abs().max().item()
        gerr = (gg - gc).abs().max().item()
        rel = abs(lg - lc) / abs(lc)
        log(f"[base] {tag} seeded weights, one batch of {n}, dropout off, "
            f"card vs CPU: loss {lg:.7f} vs {lc:.7f} (rel {rel:.2e}), "
            f"gradient max |err| {gerr:.3e} of its largest entry "
            f"{gscale:.3e} ({gerr / max(gscale, 1e-30):.2e}; bar "
            f"{BASE_GRAD_TOL})")
        check(rel <= BASE_GRAD_TOL, f"{tag}: card loss {lg} vs CPU {lc}")
        check(gerr <= BASE_GRAD_TOL * gscale,
              f"{tag}: card gradients {gerr:.3e} from the CPU's "
              f"(scale {gscale:.3e})")

        # the recipe's train step (forward with dropout, backward, Adam) at
        # the trained weights
        state, apply_fn = build_trainer(cfg, dev)
        state.model.load_state_dict(trained)
        step = make_train_step(apply_fn, state.optimizer)
        batch = {"x": x.to(dev), "labels": y.to(dev)}
        ms = cuda_ms(lambda: step(batch), 20)
        log(f"[time] {tag} recipe step (fwd + bwd + Adam, dropout on), batch "
            f"{n} x {tuple(x.shape[1:])}: {ms:.4f} ms = {n / ms * 1e3:.1f} "
            f"inputs/s (CUDA events, 20 steps) ({name_limit})")
    log(f"[base] training half: {time.perf_counter() - t_phase:.1f} s")
    return dirs


def baselines_eval_phase(csv, audio, dirs, name_limit):
    """Phase 11, its evaluation half, on phase 10's corpus: ``cli eval``
    of each trained baseline, expt 1 and expt 2, on the card from the
    ``.pth`` and ``reference_config.json`` that training wrote; each file
    has the keys and lists of ``artifacts/cli_cycle/paper_plots/``, every
    maxK spread is 0, no kernel is launched, and a cut of the sweep (expt 1
    at the full rate and two windows, maxK at three K) on every fifth test
    clip agrees, card against CPU, within SWEEP_TOL, with the trained
    weights and with the recipe's seeded ones."""
    t_phase = time.perf_counter()
    for tag in BASELINES:
        d = dirs[tag]
        config = os.path.join(d, "reference_config.json")
        pth = os.path.join(d, f"{tag}_net.pth")
        out = os.path.join(d, "eval")
        zero_counts()
        t0 = time.perf_counter()
        results, prov = cli.main(["eval", "--config", config, "--pth", pth,
                                  "--esc-csv", csv, "--esc-audio", audio,
                                  "--experiments", "expt1", "expt2",
                                  "--out-dir", out, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: n for k, n in kernel_counts().items() if n}
        check(not counts, f"cli eval {tag} launched kernels {counts}")
        check(prov["engine"] == "plain" and prov["backend"] == "cuda",
              f"{tag} eval: engine {prov['engine']} on {prov['backend']}")
        names = [f"{tag}_expt1.json", f"{tag}_randK_expt2.json",
                 f"{tag}_maxK_expt2.json"]
        check(sorted(results) == sorted(names), f"{tag} eval wrote {sorted(results)}")
        for name in names:
            with open(os.path.join(out, name)) as f:
                got = json.load(f)
            with open(os.path.join(ROOT, "artifacts", "cli_cycle", "paper_plots",
                                   name)) as f:
                ref = json.load(f)
            with open(os.path.join(out, name.replace(".json", ".provenance.json"))) as f:
                sweep_s = json.load(f)["wall_s"]
            check(list(got) == list(ref), f"{name}: keys {list(got)} vs {list(ref)}")
            for key in ref:
                if key != "data":
                    check(got[key] == ref[key], f"{name}: {key} differs")
            check(list(got["data"]) == list(ref["data"]), f"{name}: data keys differ")
            check(all(len(g) == len(r) for g, r in zip(got["data"].values(),
                                                        ref["data"].values())),
                  f"{name}: cell counts differ")
            if "maxK" in name:
                check(all(v[1] == 0 for v in got["data"].values()),
                      f"{name}: a maxK spread is not 0")
            cells = [a for v in got["data"].values()
                     for a in (v if "list_N" in got else v[:1])]
            log(f"[base] {name}: {sweep_s:.2f} s of wall time on the card; keys "
                f"and lists identical to the JAX package's file; accuracies "
                f"{min(cells):.4f}-{max(cells):.4f} ({name_limit})")
        log(f"[base] cli eval {tag} expt1 expt2: {wall:.1f} s, engine "
            f"{prov['engine']}; no kernel launched")

        # the cut on the card and on the CPU with the trained weights and,
        # since a trained FB can name one class everywhere, with the
        # recipe's seeded ones
        t0 = time.perf_counter()
        cfg = ExperimentConfig.from_reference_json(config)
        trained = cfg.build_model()
        trained.load_state_dict(load_reference_pth(pth))
        waves, lengths, labels = load_esc_split_waves(csv, audio, cfg.numpy_seed,
                                                      split="test")
        few = slice(0, None, BASE_CUT_STRIDE)
        list_K = results[names[2]]["list_K"]
        windows = BASE_CPU_WINDOWS[tag]
        Ks = [list_K[0], list_K[len(list_K) // 2], list_K[-1]]
        names_cut = [f"expt1 N={N}" for N in windows] + [f"maxK K={K}" for K in Ks]
        for which, model in (("trained", trained),
                             ("seeded", build_trainer(cfg, "cpu")[0].model)):
            on_card, on_cpu = (baseline_cut(tag, cfg, model, waves[few], lengths[few],
                                            labels[few], windows, Ks, where)
                               for where in ("cuda", "cpu"))
            devs = [(abs(a - b), f"{c} card {a:.6f} CPU {b:.6f}")
                    for c, a, b in zip(names_cut, on_card, on_cpu)]
            log(f"[base] {tag} sweep cut, {which} weights, {len(labels[few])} clips, "
                "card vs CPU: " + "; ".join(c for _, c in devs))
            for dv, cell in devs:
                check(dv <= SWEEP_TOL,
                      f"{tag} {which} card vs CPU: {cell} beyond {SWEEP_TOL}")
        log(f"[base] {tag} sweep cuts: {time.perf_counter() - t0:.1f} s")

        # the trained recipe's step by kernel, profiled here at the end of
        # the run: a profile leaves later host-bound launches slower
        state, apply_fn = build_trainer(cfg, "cuda")
        state.model.load_state_dict(load_reference_pth(pth))
        data = prepare_data(waves[:8], lengths[:8], labels[:8], cfg, device="cuda")
        n = cfg.batch_size
        batch = {"x": torch.from_numpy(data["x"][:n]).cuda(),
                 "labels": torch.from_numpy(data["labels"][:n]).long().cuda()}
        step = make_train_step(apply_fn, state.optimizer)
        per, idle = profile_device(lambda: step(batch), 5)
        check(not any(k.startswith("Optimizer.") for k in per),
              f"{tag} step profile counts an annotation range: {list(per)[:5]}")
        log(f"[time] {tag} step profile: device {sum(per.values()):.4f} ms a step in "
            f"{len(per)} kernels, idle share {idle:.4f}; by kernel: "
            + "; ".join(f"{_short(k)} {v:.4f}" for k, v in list(per.items())[:8])
            + f" ({name_limit})")
    log(f"[base] evaluation half: {time.perf_counter() - t_phase:.1f} s")


@torch.no_grad()
def baseline_cut(tag, cfg, model, waves, lengths, labels, windows, Ks, device):
    """Phase 11's cut of a baseline sweep on ``device``: expt 1's accuracies
    at the full rate and ``windows``, then maxK's at ``Ks``."""
    model = model.to(device).eval()
    common = dict(fsog=cfg.sampling_rate, Nfft=cfg.window_size,
                  hf=cfg.hop_factor, tDb=cfg.trim_dB, device=device)
    if tag == "FB":
        fn = make_fb_frame_classifier(model)
        e1 = framewise_expt1(fn, waves, lengths, labels, fixed_nfft=True,
                             list_Fs=[cfg.sampling_rate], list_N=windows, **common)
        _, mx = framewise_expt2(fn, None, waves, lengths, labels, mode="replace",
                                list_K=Ks, nruns=1, **common)
    else:
        fn = make_cnn_chunk_classifier(model)
        e1 = temporal_expt1(fn, waves, lengths, labels, Ntemp=cfg.Ntemp,
                            fixed_nfft=True, list_Fs=[cfg.sampling_rate],
                            list_N=windows, **common)
        _, mx = temporal_expt2(None, fn, waves, lengths, labels, mode="replace",
                               Ntemp=cfg.Ntemp, list_K=Ks, nruns=1, **common)
    return e1["data"][cfg.sampling_rate] + [mx["data"][K][0] for K in Ks]


def start_ingest_corpus():
    """Start writing phase 9's WAV files (INGEST_FILES of 5 s, 0.9 GB) in a
    process of its own during the build, whose compilers leave cores idle
    for most of it; phase 9 waits for it."""
    work = tempfile.mkdtemp(prefix="pcaudio_ingest_")
    atexit.register(shutil.rmtree, work, True)
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys; from pcaudio_torch.probes.ingest import "
         "write_corpus; write_corpus(sys.argv[1], int(sys.argv[2]))", work,
         str(INGEST_FILES)], cwd=ROOT)
    atexit.register(proc.kill)
    return proc, work


def ingest_phase(name_limit, corpus_job):
    """Phase 9: the probe's corpus (``start_ingest_corpus``) served from WAV
    files through the native ring, K3-K2-K1 on the card; int16 staging ==
    f32 staging, == the in-memory path (also after slot reuse), then the
    probe's timings."""
    proc, work = corpus_job
    try:
        t0 = time.perf_counter()
        rc = proc.wait()
        check(rc == 0, f"the ingest corpus' writer exited with {rc}")
        paths = ingest.corpus_paths(work, INGEST_FILES)
        clips = ingest.decoded_clips(paths)
        log(f"[ingest] corpus: {len(paths)} PCM16 files of 5 s "
            f"({ingest.DISTINCT} distinct synth_clips), written during the "
            f"build; waited {time.perf_counter() - t0:.1f} s for it and read "
            f"the distinct ones; the probe's full shape (2,048 files at batch "
            f"{INGEST_BATCH})")
        check(native.available(), "the native WAV loader does not build")
        model = ingest.seeded_model(0)
        clfs = {wd: AudioClassifier(model=model, pipeline=CFG,
                                    batch_size=INGEST_BATCH, buffer_len=L,
                                    device="cuda", wave_dtype=wd)
                for wd in ingest.STAGING}
        for k in SERVE_KERNELS:
            KERNELS[k][0].launches = 0
        lg = {wd: clf.logits_paths(paths) for wd, clf in clfs.items()}
        torch.cuda.synchronize()
        launches = {k: KERNELS[k][0].launches for k in SERVE_KERNELS}
        log(f"[ingest] launches in logits_paths, the logits of classify_paths "
            f"(f32 and int16 staging): {launches}")
        for k, n in launches.items():
            check(n > 0, f"{k} was not launched on the ingest path")
        for wd, clf in clfs.items():
            pf = clf._pf
            check(pf is not None and pf.dtype == getattr(torch, wd)
                  and pf.waves[0].is_pinned(),
                  f"{wd}: classify_paths did not take the pinned native ring")
            check(lg[wd].shape == (len(paths), 10)
                  and bool(np.isfinite(lg[wd]).all()), f"{wd}: logits {lg[wd].shape}")
        check(np.array_equal(lg["int16"], lg["float32"]),
              "int16 staging differs from f32 staging: max |d| "
              f"{np.abs(lg['int16'] - lg['float32']).max():.3e}")
        ref = clfs["float32"].logits(clips)
        exact = np.array_equal(lg["float32"], ref)
        if not exact:
            k1_check(torch.from_numpy(lg["float32"]), torch.from_numpy(ref),
                     "classify_paths vs classify")
        agree, decided, dev = tie_aware_argmax(torch.from_numpy(lg["float32"]),
                                               torch.from_numpy(ref))
        log(f"[ingest] {len(paths)} files: int16 staging bit-identical to f32; "
            f"against classify on the clips in memory "
            f"{'bit-identical' if exact else f'max |d| {dev:.3e}'}, labels agree "
            f"on {agree}/{len(paths)} ({decided} decided)")
        for clf in clfs.values():
            clf.close()
        # slot reuse under copies in flight: 12 batches through 6 slots
        small = AudioClassifier(model=model, pipeline=CFG, batch_size=64,
                                buffer_len=L, device="cuda", wave_dtype="int16")
        n12 = 12 * 64 - 5  # the last bucket padded
        got = small.logits_paths(paths[:n12])
        check(small._pf.depth == 6, f"ring depth {small._pf.depth}")
        small.close()
        ref12 = AudioClassifier(model=model, pipeline=CFG, batch_size=64,
                                buffer_len=L, device="cuda").logits(clips[:n12])
        check(np.array_equal(got, ref12), "after slot reuse: classify_paths "
              f"differs from classify, max |d| {np.abs(got - ref12).max():.3e}")
        log(f"[ingest] {n12} files at batch 64 (12 batches through a ring of 6 "
            f"slots): bit-identical to classify on the clips in memory")
        ingest.measure(model, paths, INGEST_BATCH,
                       lambda line: log(f"[ingest] {line} ({name_limit})"))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def fst_checkpoint(fused_attn):
    """The trained FST (artifacts/roundtrip) on the card."""
    model = ST(dim_input=2, dim_output=10, num_inds=64, dim_hidden=64,
               num_heads=8, fused_attn=fused_attn)
    model.load_state_dict(load_reference_pth(FST_PTH))
    return model.cuda().eval()


@torch.no_grad()
def batched(fn, x, bs=_MB_FRAMES):
    return torch.cat([fn(x[i: i + bs]) for i in range(0, len(x), bs)])


def anchor_phase(csv, audio, name_limit):
    """Phase 10's accuracy anchor: the FST recipe's test clouds classified
    by the trained FST through K4, through K1 and by the f32 plain ST.
    Returns (clouds, labels) on the card."""
    cfg = RECIPES["FST"]()
    waves, lengths, labels = load_esc_split_waves(csv, audio, cfg.numpy_seed,
                                                  split="test")
    data = prepare_framewise_data(waves, lengths, labels, cfg, device="cuda")
    pts = torch.from_numpy(data["points"]).cuda()
    y = torch.from_numpy(data["labels"]).long().cuda()
    check(tuple(pts.shape) == (17280, 1025, 2), f"test clouds {tuple(pts.shape)}")
    plain = fst_checkpoint(False)
    ref = batched(plain, pts)
    got = {"K4": batched(fst_checkpoint(True), pts),
           "K1": batched(lambda x: fused_st_forward(plain, x, None), pts)}
    torch.cuda.synchronize()
    acc = {k: (v.argmax(-1) == y).double().mean().item()
           for k, v in dict(got, f32=ref).items()}
    for name, lg in got.items():
        differ = lg.argmax(-1) != ref.argmax(-1)
        top2 = ref.sort(dim=-1).values[:, -2:]
        gaps = (top2[:, 1] - top2[:, 0])[differ]
        log(f"[eval] anchor {name}: accuracy {acc[name]:.6f} (f32 {acc['f32']:.6f}),"
            f" max logit dev {(lg - ref).abs().max().item():.4e}, max |f32 logit| "
            f"{ref.abs().max().item():.2f}, {int(differ.sum())} rows differ, their "
            f"f32 top-2 gaps {sorted(gaps.tolist())[:12]} ({name_limit})")
    check(round(acc["f32"], 4) == ANCHOR_ACC, f"f32 ST accuracy {acc['f32']:.6f} on "
          f"the 17,280 test clouds does not round to {ANCHOR_ACC}")
    agree, decided, dev = tie_aware_argmax(got["K4"], ref)
    log(f"[eval] anchor K4 vs the f32 ST: {agree}/{len(y)} argmax agree "
        f"({decided} decided rows all agree), max logit dev {dev:.3e}")
    # K1 is bf16: its bar against the f32 ST is 5e-2 + 5e-2·|logit|
    # (phase 2), taken at the largest logit
    k1_tol = ST_F32_TOL * (1.0 + ref.abs().max().item())
    agree, decided, dev = tie_aware_argmax(got["K1"], ref, tol=k1_tol)
    log(f"[eval] anchor K1 vs the f32 ST: {agree}/{len(y)} argmax agree "
        f"({decided} decided rows all agree), max logit dev {dev:.3e} "
        f"(cap {k1_tol:.3f})")
    return pts, y


def sweep_deviations(got, ref, what):
    """A sweep file against the JAX package's: the same keys and lists;
    returns ``[(|deviation|, cell)]`` of every cell (expt 1: an accuracy;
    expt 2: a mean), largest first."""
    check(list(got) == list(ref), f"{what}: keys {list(got)} vs {list(ref)}")
    for key in got:
        if key != "data":
            check(got[key] == ref[key], f"{what}: {key} differs")
    check(list(got["data"]) == list(ref["data"]), f"{what}: data keys differ")
    devs = []
    for key, ref_v in ref["data"].items():
        got_v = got["data"][key]
        cells = (list(zip(got_v, ref_v)) if "list_N" in ref
                 else [(got_v[0], ref_v[0])])
        devs += [(abs(g - r), f"{key}[{i}] {g:.6f} vs {r:.6f}")
                 for i, (g, r) in enumerate(cells)]
    return sorted(devs, reverse=True)


def recording(fn, store):
    """``fn`` that also keeps each call's logits in ``store``."""
    def wrapped(*args):
        lg = fn(*args)
        store.append(lg.float())
        return lg
    return wrapped


def eval_3st_phase(csv, audio, name_limit):
    """A seeded full-width 3ST's expt 1 and expt 2 on both engines: the
    same calls in the same order (the random draws are seeded per
    microbatch), so each K4 forward's logits must agree with the plain
    one's tie-aware."""
    cfg = RECIPES["3ST"]()
    w, n, lab = load_esc_split_waves(csv, audio, cfg.numpy_seed, split="test")
    w, n, lab = w[:EVAL_3ST_CLIPS], n[:EVAL_3ST_CLIPS], lab[:EVAL_3ST_CLIPS]
    plain = seeded_st(3, seed=9)
    k4 = ST(dim_input=3, dim_output=10, num_inds=64, dim_hidden=64,
            num_heads=8, fused_attn=True)
    k4.load_state_dict(plain.state_dict())
    k4 = k4.cuda().eval()
    common = dict(fsog=cfg.sampling_rate, Nfft=cfg.window_size, Ntemp=cfg.Ntemp,
                  hf=cfg.hop_factor, tDb=cfg.trim_dB, device="cuda")
    logits, res = {}, {}
    for name, model in (("K4", k4), ("plain", plain)):
        logits[name] = store = []
        t0 = time.perf_counter()
        e1 = temporal_expt1(recording(make_3st_chunk_classifier(model), store),
                            w, n, lab, **common)
        t1 = time.perf_counter()
        e2 = temporal_expt2(recording(make_cloud_classifier(model), store), None,
                            w, n, lab, mode="cloud", list_K=EVAL_3ST_K,
                            nruns=EVAL_3ST_RUNS, **common)
        t2 = time.perf_counter()
        res[name] = (e1, e2)
        log(f"[eval] 3ST {name} engine, {EVAL_3ST_CLIPS} clips: expt1 "
            f"{t1 - t0:.1f} s, expt2 (K {EVAL_3ST_K}, {EVAL_3ST_RUNS} runs) "
            f"{t2 - t1:.1f} s; {len(store)} forwards ({name_limit})")
    check(len(logits["K4"]) == len(logits["plain"]), "3ST: the engines made "
          "different numbers of forwards")
    agree = rows = decided = 0
    dev = 0.0
    for a, b in zip(logits["K4"], logits["plain"]):
        ag, de, dv = tie_aware_argmax(a, b)
        agree, decided, rows, dev = agree + ag, decided + de, rows + len(a), max(dev, dv)
    e1k, e1p = res["K4"][0]["data"], res["plain"][0]["data"]
    diffs = [abs(g - r) for F in e1k for g, r in zip(e1k[F], e1p[F])]
    for part in range(2):  # randK, maxK: the means
        dk, dp = res["K4"][1][part]["data"], res["plain"][1][part]["data"]
        diffs += [abs(dk[k][0] - dp[k][0]) for k in dk]
    log(f"[eval] 3ST K4 vs plain engine: {agree}/{rows} rows agree over "
        f"{len(logits['K4'])} forwards ({decided} decided rows all agree), max "
        f"logit dev {dev:.3e}; largest accuracy difference {max(diffs):.3e}")


def rebut_phase(csv, audio, work, name_limit):
    """``cli eval --experiments rebut`` on a cut of phase 10's corpus (its
    first 2 clips a class) with a seeded 3ST at the recipe's width (64
    hidden, 64 inducing points, 8 heads) whose output layer standardises
    each class's logit over those clips' clouds (left as drawn it names
    one class everywhere), on
    the card through K4 behind the parity gate, at the CLI's one window
    width (64) and every K.  Its files are checked by schema and range;
    its maxK and randK cells at REBUT_K are held within SWEEP_TOL of the
    same sweep on the card's plain engine (the function the CLI calls,
    plain attention, the same seed: the same heat-maps and the same
    multinomial draws).  Returns K4's forward launches."""
    cfg = RECIPES["3ST"]()
    root = os.path.join(work, "rebut")
    os.makedirs(root, exist_ok=True)
    cut_csv = os.path.join(root, "cut.csv")
    with open(csv) as f:
        lines = f.read().splitlines()
    with open(cut_csv, "w") as f:
        f.write("\n".join([lines[0]] + [r for r in lines[1:]
                                         if int(r.split("-")[1]) % 1000 < 2]) + "\n")
    w, n, lab = load_esc_split_waves(cut_csv, audio, cfg.numpy_seed, split="test")
    model = seeded_st(3, seed=11)
    cloud, cm = extract_chunk_clouds(
        torch.from_numpy(w).cuda(), torch.from_numpy(n).cuda(),
        TemporalPipelineConfig(top_k=None, featurize="xla"))
    pts = cloud.points[cm.reshape(-1)]
    del cloud
    with torch.no_grad():
        # each class's logit to mean 0 and variance 1 over these clouds, so
        # that the argmax spreads over the classes
        lg = batched(model, pts, bs=_MB_CHUNKS)
        mu, sd = lg.mean(0), lg.std(0)
        head = model.dec[1]
        head.weight.div_(sd[:, None])
        head.bias.sub_(mu).div_(sd)
        named = ((lg - mu) / sd).argmax(-1).unique().numel()
    del pts, lg
    check(named > 1, f"rebut: the standardised 3ST names {named} class on the cut")
    pth, config = os.path.join(root, "3ST_net.pth"), os.path.join(root, "3ST_config.json")
    export_reference_pth(model, pth, cfg)
    with open(config, "w") as f:
        json.dump(cfg.to_reference_json(), f)
    out = os.path.join(root, "out")
    fused_mha_fwd.launches = 0
    t0 = time.perf_counter()
    _, prov = cli.main(["eval", "--config", config, "--pth", pth, "--esc-csv",
                        cut_csv, "--esc-audio", audio, "--experiments", "rebut",
                        "--out-dir", out, "--device", "cuda"])
    torch.cuda.synchronize()
    card_s, k4 = time.perf_counter() - t0, fused_mha_fwd.launches
    check(prov["engine"] == "fused" and k4 > 0, f"cli eval rebut: engine "
          f"{prov['engine']}, {k4} K4 launches")
    res = {}
    for part in ("randK", "maxK"):
        with open(os.path.join(out, f"3ST_rebut_expt_{part}.json")) as f:
            res[part] = got = json.load(f)
        check(list(got) == ["data", "list_K"] and list(got["data"]) == ["64"]
              and got["list_K"] == default_list_K(FULL_POINTS)
              and list(got["data"]["64"]) == [str(k) for k in got["list_K"]],
              f"3ST_rebut_expt_{part}.json: keys or lists differ")
        for mean, var in got["data"]["64"].values():
            check(0.0 <= mean <= 1.0 and var >= 0.0 and (part == "randK" or var == 0),
                  f"3ST_rebut_expt_{part}.json: cell [{mean}, {var}]")
    t0 = time.perf_counter()
    plain = dict(zip(("randK", "maxK"), rebut_importance_expt(
        make_cloud_classifier(model), w, n, lab, fsog=cfg.sampling_rate,
        Nfft=cfg.window_size, Ntemp=cfg.Ntemp, hf=cfg.hop_factor, tDb=cfg.trim_dB,
        list_K=REBUT_K, device="cuda")))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    cells = {part: [(abs(res[part]["data"]["64"][str(k)][0] - plain[part]["data"][64][k][0]),
                     k, res[part]["data"]["64"][str(k)][0]) for k in REBUT_K]
             for part in plain}
    for part, devs in cells.items():
        for d, k, acc in devs:
            check(d <= SWEEP_TOL, f"rebut {part} K {k}: K4 {acc} vs plain engine "
                  f"{plain[part]['data'][64][k][0]}")
    accs = {part: [v[0] for v in res[part]["data"]["64"].values()] for part in res}
    log(f"[eval] cli eval rebut, 3ST at the recipe's width, seeded, logits standardised "
        f"({named} classes named), {len(lab)} test clips of the 2-a-class cut: "
        f"{card_s:.1f} s on the card ({k4} K4 forward launches, engine "
        f"{prov['engine']}), accuracies over {len(accs['maxK'])} K: maxK "
        f"{min(accs['maxK']):.4f}-{max(accs['maxK']):.4f}, randK "
        f"{min(accs['randK']):.4f}-{max(accs['randK']):.4f}; K4 vs the plain "
        f"engine at K {REBUT_K} (plain {plain_s:.1f} s): " + "; ".join(
            f"{part} " + ", ".join(f"{acc:.4f} ({d:.4f} apart)" for d, _, acc in devs)
            for part, devs in cells.items()) + f" ({name_limit})")
    return k4


def start_corpus(corpus_dir, clips_per_class):
    """Start writing a synthetic ESC-10 corpus in a process of its own, so
    that its numpy runs beside the build (phase 6's) or phase 8's GPU-bound
    probes (phase 10's); the phase that reads it waits (``wait_corpus``)."""
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys; from pcaudio_torch.data import "
         "generate_esc_corpus; generate_esc_corpus(sys.argv[1], "
         "clips_per_class=int(sys.argv[2]))", corpus_dir, str(clips_per_class)],
        cwd=ROOT)
    atexit.register(proc.kill)
    return proc, corpus_dir, clips_per_class


def wait_corpus(job):
    """Wait for ``start_corpus``' writer; returns ``(csv, audio dir, s
    waited)``."""
    proc, corpus_dir, clips_per_class = job
    t0 = time.perf_counter()
    rc = proc.wait()
    check(rc == 0, f"the writer of {corpus_dir} exited with {rc}")
    # the writer left every clip in place: this writes the csv only
    csv, audio = generate_esc_corpus(corpus_dir, clips_per_class=clips_per_class)
    return csv, audio, time.perf_counter() - t0


def eval_phase(name_limit, base_dirs, work, corpus_job):
    """Phase 10, then phase 11's evaluation half on its corpus; returns K4's
    forward launches in ``cli eval``."""
    try:
        csv, audio, waited = wait_corpus(corpus_job)
        log(f"[eval] synthetic ESC-10 corpus, 40 clips per class, written "
            f"during phase 8; waited {waited:.1f} s for it")
        pts, y = anchor_phase(csv, audio, name_limit)

        config = os.path.join(work, "FST_config.json")
        with open(config, "w") as f:
            json.dump(RECIPES["FST"]().to_reference_json(), f)
        out = os.path.join(work, "out")
        os.environ.pop("PCAUDIO_FUSED_ATTN", None)
        fused_mha_fwd.launches = 0
        t0 = time.perf_counter()
        _, prov = cli.main(["eval", "--config", config, "--pth", FST_PTH,
                            "--esc-csv", csv, "--esc-audio", audio,
                            "--experiments", "expt1", "expt2", "--out-dir", out,
                            "--device", "cuda"])
        torch.cuda.synchronize()
        launches = fused_mha_fwd.launches
        log(f"[eval] cli eval FST expt1 expt2: {time.perf_counter() - t0:.1f} s, "
            f"engine {prov['engine']}, gate {json.dumps(prov.get('fused_gate'))}")
        # 5 attends a forward; expt 2 alone: 17 microbatches x 21 K x 11
        n_mb = -(-len(y) // _MB_FRAMES)
        least = 5 * (n_mb * len(default_list_K(1024)) * 11 + 2)
        check(prov["engine"] == "fused" and launches >= least,
              f"cli eval: engine {prov['engine']}, {launches} K4 launches "
              f"(expt 2 and the gate alone make {least})")
        worst = {}
        for name in ("FST_expt1.json", "FST_maxK_expt2.json", "FST_randK_expt2.json"):
            with open(os.path.join(out, name)) as f:
                got = json.load(f)
            with open(os.path.join(ROOT, "artifacts", "roundtrip", name)) as f:
                ref = json.load(f)
            with open(os.path.join(out, name.replace(".json", ".provenance.json"))) as f:
                wall = json.load(f)["wall_s"]
            devs = sweep_deviations(got, ref, name)
            worst[name] = devs[0]
            log(f"[eval] {name}: {wall:.1f} s of wall time; against the JAX "
                f"package's file: keys and lists identical, largest deviations "
                + "; ".join(f"{d:.4f} at {c}" for d, c in devs[:4])
                + f" ({name_limit})")
        log(f"[eval] K4 forward launches in cli eval: {launches} ({name_limit})")
        for name, (d, cell) in worst.items():
            check(d <= SWEEP_TOL, f"{name}: cell {cell} beyond {SWEEP_TOL}")

        # K4's share of one expt-2 microbatch (21 K x 11 masks of 1024 clouds)
        model = fst_checkpoint(True)
        gen = torch.Generator(device="cuda")
        mb = slice(0, _MB_FRAMES)

        def one_microbatch():
            gen.manual_seed(0)
            with torch.no_grad():
                return _prefix_mask_counts(make_cloud_classifier(model), pts[mb],
                                           pts[mb, :, 1], y[mb], None, gen,
                                           default_list_K(1024), 10)
        wall = cuda_ms(one_microbatch, 1)
        per, idle = profile_device(one_microbatch, 1)
        k4_names = [k for k in per if any(f"{n}<" in k for n in FWD_KERNELS)]
        check(bool(k4_names), f"the expt-2 microbatch's profile holds none of K4's "
              f"forward kernels {FWD_KERNELS}; its kernels: {list(per)[:8]}")
        k4 = sum(per[k] for k in k4_names)
        total = sum(per.values())
        log(f"[eval] one expt-2 microbatch (1024 clouds x 231 masks): {wall:.1f} ms; "
            f"device {total:.1f} ms, K4 {k4:.1f} ms = {k4 / total:.3f} of it, idle "
            f"share {idle:.4f}; by kernel: " + "; ".join(
                f"{k[:50]} {v:.2f}" for k, v in list(per.items())[:6])
            + f" ({name_limit})")
        del pts, y, model
        torch.cuda.empty_cache()
        eval_3st_phase(csv, audio, name_limit)
        launches += rebut_phase(csv, audio, work, name_limit)
        # ---- 11, second half: the baselines' sweeps on this corpus ---------
        phase("11, second half: the baselines' sweeps on this corpus")
        baselines_eval_phase(csv, audio, base_dirs, name_limit)
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---- phase 7's remat check and phase 12, the Set Transformer's tasks --------

def held_after_forward(apply_fn, store):
    """``apply_fn`` that notes the device memory allocated when the
    step's forward returns (its first call in a step; a remat recompute
    calls it again in the backward)."""

    def fn(batch, train=False):
        out = apply_fn(batch, train=train)
        if not store:
            store.append(torch.cuda.memory_allocated())
        return out

    return fn


def remat_modes(model):
    """The remat forms phase 7 holds against the plain step: the whole
    forward (the JAX step's form) and each of the ST's ISABs and its PMA."""
    return {"plain": False, "whole": True,
            "blocks": [model.enc[0], model.enc[1], model.dec[0]]}


def remat_phase(train_out, dev, name_limit):
    """Phase 7's remat check on the 3ST recipe step (B 16, 5,120 points,
    K4) from the trained weights and one batch, and on the FB step, whose
    dropout draws from the state's generator, from its seeded weights: one
    step each way from the same weights and generator state, the loss and
    gradients against the plain step's, K4's launches, the peak device
    memory (``max_memory_allocated`` after a reset) and the memory held
    when the forward returns, then each step's time (CUDA events, 20
    steps, in turns)."""
    cfg, batch = train_out["batches"]["3ST"]
    res, steps = {}, {}
    for mode in ("plain", "whole", "blocks"):
        state, apply_fn = build_trainer(cfg, dev, fused_attn=True)
        state.model.load_state_dict(train_out["weights"]["3ST"])
        held = []
        step = make_train_step(held_after_forward(apply_fn, held), state.optimizer,
                               remat=remat_modes(state.model)[mode],
                               generator=state.generator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts()
        m = step(batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        counts = {k: v for k, v in kernel_counts().items() if v}
        grads = torch.cat([p.grad.flatten() for p in state.model.parameters()])
        res[mode] = (m["loss"].item(), grads, peak, held[0] - base, counts)
        timed = make_train_step(apply_fn, state.optimizer,
                                remat=remat_modes(state.model)[mode],
                                generator=state.generator)
        steps[mode] = (lambda s: lambda: s(batch))(timed)
    loss0, g0, peak0, held0, counts0 = res["plain"]
    check(set(counts0) == set(TRAIN_KERNELS), f"3ST plain step launches {counts0}")
    for mode, (loss, g, peak, held, counts) in res.items():
        rel = abs(loss - loss0) / abs(loss0)
        gerr = (g - g0).abs().max().item()
        gscale = g0.abs().max().item()
        log(f"[remat] 3ST recipe step, {mode}: loss {loss:.7f} (rel {rel:.2e} of the "
            f"plain step's), gradient max |err| {gerr:.3e} of its largest entry "
            f"{gscale:.3e}; K4 launches {counts}; peak {peak / 2**20:.1f} MiB over "
            f"the step, {held / 2**20:.1f} MiB held when the forward returns "
            f"({name_limit})")
        check(rel <= 1e-6, f"3ST remat {mode}: loss {loss} vs plain {loss0}")
        check(gerr <= 1e-4 * gscale, f"3ST remat {mode}: gradients {gerr:.3e} from "
              f"the plain step's (scale {gscale:.3e})")
        if mode != "plain":
            check(counts.get("fused_mha_fwd") == 2 * counts0["fused_mha_fwd"]
                  and counts.get("fused_mha_bwd") == counts0["fused_mha_bwd"],
                  f"3ST remat {mode}: K4 launches {counts} against the plain "
                  f"step's {counts0}")
            check(held < held0, f"3ST remat {mode}: {held} bytes held after the "
                  f"forward, the plain step {held0}")
    check(res["blocks"][2] < peak0, f"3ST remat by blocks: peak {res['blocks'][2]} "
          f"bytes, the plain step's {peak0}")
    order = ("plain", "whole", "blocks", "blocks", "whole", "plain")
    ms = {m: [] for m in steps}
    for mode in order:
        ms[mode].append(cuda_ms(steps[mode], 20))
    log("[remat] 3ST recipe step time (CUDA events, 20 steps; turns plain, whole, "
        "blocks, blocks, whole, plain): " + "; ".join(
            f"{m} {np.mean(v):.3f} ms ({v[0]:.3f} / {v[1]:.3f})" for m, v in ms.items())
        + f" ({name_limit})")

    # FB: the input dropout draws from the state's generator; the remat
    # step's recompute must draw the same masks
    cfg = RECIPES["FB"]()
    rng = np.random.default_rng(11)
    batch = {"x": torch.from_numpy(rng.standard_normal(
                 (cfg.batch_size, cfg.layers[0])).astype(np.float32)).to(dev),
             "labels": torch.from_numpy(rng.integers(0, 10, cfg.batch_size)).to(dev)}
    out = {}
    for remat in (False, True):
        state, apply_fn = build_trainer(cfg, dev)
        step = make_train_step(apply_fn, state.optimizer, remat=remat,
                               generator=state.generator)
        m = step(batch)
        out[remat] = (m["loss"].item(),
                      torch.cat([p.grad.flatten() for p in state.model.parameters()]),
                      state.generator.get_state())
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    log(f"[remat] FB recipe step, seeded weights, dropout on: loss {l1:.7f} with remat "
        f"(the whole forward) vs {l0:.7f}, gradients equal: {torch.equal(g0, g1)}, "
        f"the generator ends in the same state: {torch.equal(s0, s1)}")
    check(l0 == l1 and torch.equal(g0, g1) and torch.equal(s0, s1),
          f"FB remat: loss {l1} vs {l0}, gradients max |err| "
          f"{(g1 - g0).abs().max().item():.3e}")


def mn40_clouds(n, seed, points=MN40_POINTS, classes=MN40_CLASSES):
    """``n`` ModelNet40-shaped synthetic clouds ``[n, points, 3]`` and their
    labels, from a numpy seed: the classes differ by per-axis scale ratios,
    as in tests/test_tasks.py's dump (standardization keeps them)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    c = labels / (classes - 1)
    scale = np.stack([np.ones(n), 1.0 + 3.0 * c, 1.0 / (1.0 + 2.0 * c)], axis=-1)
    x = rng.standard_normal((n, points, 3), dtype=np.float32)
    return x * scale[:, None, :].astype(np.float32), labels.astype(np.int32)


def mog_batch(seed, B=10, N=500, K=4):
    """A batch of MoG problems ``[B, N, 2]`` from a numpy seed, by the
    clustering task's generative process."""
    rng = np.random.default_rng(seed)
    pi = rng.dirichlet(np.ones(K), B)
    labels = np.stack([rng.choice(K, N, p=p) for p in pi])
    mu = rng.uniform(-4, 4, (B, K, 2))
    X = np.take_along_axis(mu, labels[..., None], 1) + 0.3 * rng.standard_normal((B, N, 2))
    return X.astype(np.float32)


def task_cases(device):
    """Each task model at full width with its build's seeded weights, in
    eval mode (dropout off), and a loss of one batch from numpy seeds:
    ``{name: (model, loss_fn)}``."""
    from pcaudio_torch.data.modelnet40 import standardize
    from pcaudio_torch.tasks import clustering, max_regression, modelnet40

    clouds, labels = mn40_clouds(64, seed=7)
    x = torch.from_numpy(standardize(clouds[:, ::10])).to(device)
    y = torch.from_numpy(labels).long().to(device)
    X = torch.from_numpy(mog_batch(8)).to(device)
    xm = torch.from_numpy(2.0 * np.random.default_rng(9).standard_normal(
        (64, 10, 1)).astype(np.float32)).to(device)
    ym = xm[..., 0].amax(-1)
    cases = {"modelnet40": (modelnet40.build(modelnet40.ModelNet40Config(), "cpu")[0],
                            lambda m: F.cross_entropy(m(x), y))}
    for name in ("set_transformer", "deepset"):
        ccfg = clustering.ClusteringConfig(model=name)
        cases[f"clustering {name}"] = (clustering.build(ccfg, "cpu")[0],
                                       lambda m: clustering._loss(m, X, 2))
    for name, make in (("max regression ST", max_regression.SmallSetTransformer),
                       ("max regression DeepSet max",
                        lambda: max_regression.SmallDeepSet("max"))):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = make()
        cases[name] = (model, lambda m: (m(xm) - ym).abs().mean())
    return {k: (m.to(device).eval(), fn) for k, (m, fn) in cases.items()}


def task_grads(device):
    """``{name: (loss, the gradient vector on the CPU)}`` of each
    :func:`task_cases` entry on ``device``."""
    out = {}
    for name, (model, loss_fn) in task_cases(device).items():
        loss = loss_fn(model)
        loss.backward()
        out[name] = (loss.item(), torch.cat(
            [p.grad.flatten() for p in model.parameters()]).cpu())
    return out


def start_task_grads_cpu():
    """Start phase 12's CPU side of the card-against-CPU gradients in a
    process of its own during the build (two threads; it never touches the
    card); its result is a ``torch.save`` file."""
    work = tempfile.mkdtemp(prefix="pcaudio_task_grads_")
    atexit.register(shutil.rmtree, work, True)
    path = os.path.join(work, "grads.pt")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, torch; torch.set_num_threads(2); "
         "import chip_smoke; torch.save(chip_smoke.task_grads('cpu'), sys.argv[1])",
         path], cwd=ROOT, env=env)
    atexit.register(proc.kill)
    return proc, path


def tasks_on_card(path, device="cuda"):
    """Phase 12's training runs, in a process of its own on the card (see
    :func:`start_tasks_on_card`); writes a JSON record to ``path``."""
    from pcaudio_torch.data.modelnet40 import ModelNet40Fetcher
    from pcaudio_torch.tasks import clustering, modelnet40

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {"device": (torch.cuda.get_device_name(0) if device == "cuda"
                      else device)}
    t0 = time.perf_counter()
    tr, ytr = mn40_clouds(MN40_TRAIN, seed=1)
    te, yte = mn40_clouds(MN40_TEST, seed=2)
    fetcher = ModelNet40Fetcher.from_arrays(tr, ytr, te, yte, 64, down_sample=10,
                                            seed=0)
    rec["mn40_data_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, hist = modelnet40.train(modelnet40.ModelNet40Config(), fetcher, epochs=1,
                                   eval_every=1, log=log, device=device)
    rec["modelnet40"] = {"steps": state.step, "history": hist,
                         "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ccfg = clustering.ClusteringConfig()
    model, cstate, losses = clustering.train(ccfg, num_steps=CLUSTER_STEPS,
                                             log_every=100, log=log, device=device)
    rec["clustering"] = {"steps": cstate.step, "losses": losses.cpu().tolist(),
                         "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    rec["clustering"]["benchmark"] = clustering.benchmark(model, ccfg, num_batches=10)
    rec["clustering"]["benchmark_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["max_regression"] = cli.main(["max-regression", "--steps", "500",
                                      "--device", device])
    rec["max_regression_s"] = time.perf_counter() - t0
    rec["launches"] = kernel_counts()
    with open(path, "w") as f:
        json.dump(rec, f)


def start_tasks_on_card():
    """Start phase 12's training runs (ModelNet40's epoch and eval,
    CLUSTER_STEPS clustering steps and the benchmark, ``cli
    max-regression``) in a process of its own during the build: no kernel
    is on their path, and the card idles while nvcc runs.  Its output goes
    to a log file; phase 12 reads its record."""
    work = tempfile.mkdtemp(prefix="pcaudio_tasks_")
    atexit.register(shutil.rmtree, work, True)
    path, log_path = os.path.join(work, "tasks.json"), os.path.join(work, "tasks.log")
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.tasks_on_card(sys.argv[1])", path],
            cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
    atexit.register(proc.kill)
    return proc, path, log_path


def wait_job(proc, what, log_path=None):
    """Wait for a process of :func:`start_tasks_on_card` or
    :func:`start_task_grads_cpu`; returns the seconds waited."""
    t0 = time.perf_counter()
    rc = proc.wait()
    if rc != 0 and log_path:
        with open(log_path) as f:
            log(f.read()[-4000:])
    check(rc == 0, f"{what} exited with {rc}")
    return time.perf_counter() - t0


def mn40_step_flops(B=64, N=1000, d=256, m=16, din=3, nout=40):
    """f32 multiply-adds × 2 of one ModelNet40 forward (Linear layers and
    the attention products; LayerNorm-free, elementwise work left out)."""
    def mab(nq, nk, dq, dk):
        return nq * dq * d + 2 * nk * dk * d + 2 * nq * nk * d + nq * d * d
    per = 0
    for dx in (din, d):  # two ISABs
        per += mab(m, N, d, dx) + mab(N, m, dx, d)
    per += mab(1, N, d, d) + d * nout  # PMA, then the Linear
    return 2.0 * B * per


def tasks_phase(tasks_job, grads_job, name_limit):
    """Phase 12: the Set Transformer's tasks at the JAX defaults' full
    widths.  Reads the training runs made beside the build (every loss
    finite, the clustering loss falling, the benchmark finite, the
    max-regression MAEs, no K1-K4 launch), holds each task model's loss and
    gradients on the card against the CPU's, then times each task's step
    and profiles ModelNet40's; no K1-K4 launch here either."""
    from pcaudio_torch.data.modelnet40 import standardize
    from pcaudio_torch.tasks import clustering, max_regression, modelnet40

    path = tasks_job[1]
    with open(path) as f:
        rec = json.load(f)
    launched = {k: n for k, n in rec["launches"].items() if n}
    check(not launched, f"the tasks' training runs launched kernels {launched}")
    mn = rec["modelnet40"]
    h = mn["history"][0]
    check(mn["steps"] == MN40_TRAIN // 64 - 1, f"ModelNet40: {mn['steps']} steps")
    check(bool(np.isfinite([h["train_loss"], h["train_accuracy"], h["test_accuracy"]]).all()),
          f"ModelNet40 epoch record {h}")
    log(f"[tasks] ModelNet40 (dim 256, 4 heads, 16 inducing points, 1,000 of "
        f"{MN40_POINTS:,} points, batch 64, 40 classes; {MN40_TRAIN} train / "
        f"{MN40_TEST} test synthetic clouds through ModelNet40Fetcher.from_arrays, "
        f"made in {rec['mn40_data_s']:.1f} s): 1 epoch = {mn['steps']} steps and one "
        f"eval in {mn['s']:.1f} s on {rec['device']}: mean train loss "
        f"{h['train_loss']:.4f} (every step finite), train accuracy "
        f"{h['train_accuracy']:.4f}, test accuracy {h['test_accuracy']:.4f} "
        f"({name_limit})")
    cl = rec["clustering"]
    losses = np.asarray(cl["losses"])
    first, last = losses[:50].mean(), losses[-50:].mean()
    mll, oll = cl["benchmark"]
    log(f"[tasks] MoG clustering (ST, dim 128, 32 inducing points, 4 heads, ln; K 4, "
        f"B 10, N 100-500): {cl['steps']} steps in {cl['s']:.1f} s, mean loss of the "
        f"first 50 {first:.4f}, of the last 50 {last:.4f}; benchmark (10 batches of "
        f"500 points, {cl['benchmark_s']:.1f} s): model {mll:.4f}, oracle {oll:.4f} "
        f"({name_limit})")
    check(cl["steps"] == CLUSTER_STEPS and bool(np.isfinite(losses).all()),
          f"clustering: {cl['steps']} steps, a loss not finite")
    check(last < first, f"clustering: the last 50 losses' mean {last} is not below "
          f"the first 50's {first}")
    check(bool(np.isfinite([mll, oll]).all()), f"clustering benchmark {mll}, {oll}")
    mr = rec["max_regression"]
    log(f"[tasks] cli max-regression --steps 500 --device cuda ("
        f"{rec['max_regression_s']:.1f} s): {json.dumps(mr)} ({name_limit})")
    check(bool(np.isfinite(list(mr.values())).all())
          and mr["set_transformer"] < 1.0 and mr["deepset_max"] < 1.0,
          f"max-regression MAEs {mr}")
    log("[tasks] the training runs ran beside the build and phases 2-3; K1-K4 "
        "launches over them: none")

    zero_counts()
    waited = wait_job(grads_job[0], "the CPU side of the task gradients")
    cpu = torch.load(grads_job[1])
    card = task_grads("cuda")
    for name, (lg, gg) in card.items():
        lc, gc = cpu[name]
        gscale = gc.abs().max().item()
        gerr = (gg - gc).abs().max().item()
        rel = abs(lg - lc) / abs(lc)
        log(f"[tasks] {name}, full width, seeded weights, dropout off, one batch, "
            f"card vs CPU: loss {lg:.7f} vs {lc:.7f} (rel {rel:.2e}), gradient max "
            f"|err| {gerr:.3e} of its largest entry {gscale:.3e} "
            f"({gerr / max(gscale, 1e-30):.2e}; bar {TASK_GRAD_TOL})")
        check(rel <= TASK_GRAD_TOL, f"{name}: card loss {lg} vs CPU {lc}")
        check(gerr <= TASK_GRAD_TOL * gscale, f"{name}: card gradients {gerr:.3e} "
              f"from the CPU's (scale {gscale:.3e})")
    log(f"[tasks] the CPU side ran beside the build; waited {waited:.1f} s for it")

    # each task's step, timed (CUDA events, 20 steps), on one batch
    cases = task_cases("cuda")
    mcfg = modelnet40.ModelNet40Config()
    model, optimizer = modelnet40.build(mcfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    train_step, _ = modelnet40.make_steps(model, optimizer, gen)
    clouds, labels = mn40_clouds(64, seed=7)
    batch = {"points": torch.from_numpy(standardize(clouds[:, ::10])).cuda(),
             "labels": torch.from_numpy(labels).cuda()}
    ms = cuda_ms(lambda: train_step(batch), 20)
    flops = 3 * mn40_step_flops()
    b_ms = bound_ms({"f32": flops}, 0)[0]
    per, idle = profile_device(lambda: train_step(batch), 5)
    dev_ms = sum(per.values())
    log(f"[time] ModelNet40 step (fwd + bwd + Adam, dropout on), batch 64 x 1000 "
        f"points, dim 256: {ms:.3f} ms = {64 / ms * 1e3:.1f} clouds/s (CUDA events, 20 "
        f"steps); device {dev_ms:.3f} ms a step in {len(per)} kernels, idle share "
        f"{idle:.4f}; {flops / 1e9:.1f} GFLOP a step (3 x the forward's products), "
        f"bound {b_ms:.3f} ms at the f32 peak = {b_ms / ms:.3f} of the step; by "
        f"kernel: " + "; ".join(f"{_short(k)} {v:.3f}" for k, v in list(per.items())[:6])
        + f" ({name_limit})")
    cmodel, copt, csched = clustering.build(clustering.ClusteringConfig(), "cuda")
    cstep = clustering.make_train_step(cmodel, copt, csched, clustering.ClusteringConfig())
    X = torch.from_numpy(mog_batch(12, N=300)).cuda()
    c_ms = cuda_ms(lambda: cstep(X), 20)
    parts = [f"ModelNet40 {ms:.3f} ms", f"clustering ST (B 10, N 300) {c_ms:.3f} ms"]
    for name in ("max regression ST", "max regression DeepSet max"):
        m = cases[name][0].train()
        opt = torch.optim.Adam(m.parameters(), lr=1e-3)
        g = torch.Generator(device="cuda").manual_seed(0)

        def mstep(m=m, opt=opt, g=g):
            xb, yb = max_regression.sample_batch(g)
            loss = (m(xb) - yb).abs().mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        parts.append(f"{name} (B 64, N 10) {cuda_ms(mstep, 20):.3f} ms")
    log("[time] task steps (CUDA events, 20 steps each): " + "; ".join(parts)
        + f" ({name_limit})")
    launched = {k: n for k, n in kernel_counts().items() if n}
    check(not launched, f"phase 12 launched kernels {launched}")
    log("[tasks] K1-K4 launches over phase 12's card work: none")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this smoke run needs an NVIDIA GPU")
    dev = torch.device("cuda")

    # ---- 0. the card -------------------------------------------------------
    phase("0. the card")
    name_limit = card()
    log(name_limit)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- 1. build ----------------------------------------------------------
    phase("1. build")
    t0 = time.perf_counter()
    # the earlier design of the redesigned probe kernels (phase 8),
    # its compilers started beside the main build's
    old_jobs = probe_stages.start_old_builds()
    # phase 6's and phase 9's corpora, written beside the compilers
    train_corpus = tempfile.mkdtemp(prefix="pcaudio_train_corpus_")
    atexit.register(shutil.rmtree, train_corpus, True)
    train_job = start_corpus(train_corpus, CLIPS_PER_CLASS)
    ingest_job = start_ingest_corpus()
    # phase 12's training runs on the card and its CPU gradients
    tasks_job = start_tasks_on_card()
    grads_job = start_task_grads_cpu()
    try:
        lib_path = _build.build()
        _build.library()
    except BaseException:
        for *_, proc in old_jobs.values():
            proc.kill()
        raise
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    sass_job = start_sass_dump(lib_path)
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[ptxas] {line.strip()}")
        elif line.startswith("[nvcc]"):
            log(line)

    # ---- 2. each kernel vs its plain version at main-path shapes ------------
    phase("2. each kernel vs its plain version at main-path shapes")
    rng = np.random.default_rng(0)
    w_np, len_np = synthetic_waves(64, rng)
    waves = torch.from_numpy(w_np).to(dev)
    lengths = torch.from_numpy(len_np).to(dev)
    errs = {}

    grids = {}
    for dt in (torch.float32, torch.bfloat16):
        g, gm = fused_chunk_mag2(waves, lengths, out_dtype=dt)
        r, rm = fused_chunk_mag2_plain(waves, lengths, out_dtype=dt)
        torch.cuda.synchronize()
        check(not gm[2].any() and not gm[3].any(),
              "K3: sub-n_fft clips must be fully masked")
        err, rel = k3_check(g, gm, r, rm, dt, str(dt))
        log(f"[K3] {dt}: max |err| {err:.3e} (max rel to chunk max {rel:.3e}), "
            f"valid chunks {int(rm.sum())}/{rm.numel()}")
        if dt == torch.float32:
            errs["fused_chunk_mag2"] = err
        grids[dt] = g

    tie_grid = torch.floor(torch.rand(512, 10, 512, device=dev,
                                      generator=torch.Generator(dev).manual_seed(1)
                                      ) * 16) / 4
    sel_err = 0.0
    for label, m in (("f32 grid", grids[torch.float32]),
                     ("bf16 grid", grids[torch.bfloat16]),
                     ("tie-heavy", tie_grid),
                     ("tie-heavy bf16", tie_grid.bfloat16())):
        m = m.reshape(-1, 10, 512)
        v, i = exact_topk_chunks(m, TOP_K)
        rv, ri = exact_topk_chunks_plain(m, TOP_K)
        torch.cuda.synchronize()
        check(torch.equal(i, ri), f"K2 {label}: selected indices differ")
        check(torch.equal(v, rv), f"K2 {label}: values differ")
        sel_err = max(sel_err, (v - rv).abs().max().item())
        log(f"[K2] {label} {tuple(m.shape)}: identical sets and values")
    # K above the TPU kernel's 256 (expt 2's 512 and every bin, Nt·F = 5120)
    for k in (512, 5120):
        m = grids[torch.float32].reshape(-1, 10, 512)
        v, i = exact_topk_chunks(m, k)
        rv, ri = exact_topk_chunks_plain(m, k)
        torch.cuda.synchronize()
        check(torch.equal(i, ri) and torch.equal(v, rv), f"K2 K={k}: differs")
        log(f"[K2] K={k} on {tuple(m.shape)}: identical sets and values")
    # -0.0 ties with 0.0 (a tie grid, 99 % zeros, half of them -0.0, so
    # that the top K reaches into the zeros); K 1 and every bin on a
    # tie-heavy bf16 grid; one chunk, fewer than the SMs
    negzero = torch.from_numpy(negzero_grid(512, 512, seed=3)).to(dev)
    for label, m, k in (("-0.0 grid", negzero, TOP_K),
                        ("-0.0 grid bf16", negzero.bfloat16(), TOP_K),
                        ("tie-heavy bf16 K=1", tie_grid.bfloat16(), 1),
                        ("tie-heavy bf16 K=Nt·F", tie_grid.bfloat16(), 5120),
                        ("one chunk", grids[torch.float32].reshape(-1, 10, 512)[5:6], TOP_K),
                        ("one chunk bf16 K=Nt·F", tie_grid[7:8].bfloat16(), 5120)):
        v, i = exact_topk_chunks(m, k)
        rv, ri = exact_topk_chunks_plain(m, k)
        torch.cuda.synchronize()
        check(torch.equal(i, ri), f"K2 {label}: selected indices differ")
        check(torch.equal(v, rv), f"K2 {label}: values differ")
        log(f"[K2] {label} {tuple(m.shape)} K={k}: identical sets and values"
            + (f" ({int(torch.signbit(v).sum())} -0.0 values selected)"
               if label.startswith("-0.0") else ""))
    errs["exact_topk_chunks"] = sel_err

    model = seeded_st(3, seed=0)
    cloud, _ = extract_chunk_clouds(waves, lengths, CFG)
    got = fused_st_forward(model, cloud.points, None)
    ref = fused_st_forward_plain(model, cloud.points, None)
    torch.cuda.synchronize()
    check(got.shape == (64 * 43, 10), f"K1: logits shape {tuple(got.shape)}")
    st_err = k1_check(got, ref, f"3ST {tuple(cloud.points.shape)} bf16 points")
    f32_err = k1_check(got, model(cloud.points.float()), "3ST vs the f32 ST",
                       tol=ST_F32_TOL)
    log(f"[K1] 3ST {tuple(cloud.points.shape)} bf16 points, mask None: max |err| "
        f"{st_err:.3e} against the plain version (bar {K1_TOL} abs + rel), "
        f"{f32_err:.3e} against the f32 ST (bar {ST_F32_TOL})")
    errs["fused_st_forward"] = st_err
    # every K the kernel must take: FST's 1025-point frames, the serving
    # default 256, odd sizes; din 2 and 3; f32 and bf16 points; no mask,
    # ragged masks (one cloud full, one empty) and every key masked
    t0 = time.perf_counter()
    worst = {"plain": 0.0, "f32": 0.0}
    for din in (2, 3):
        st_model = seeded_st(din, seed=din)
        for K in K1_POINTS:
            pts = torch.from_numpy(rng.standard_normal((32, K, din)).astype(
                np.float32)).to(dev)
            counts = torch.from_numpy(rng.integers(0, K + 1, 32)).to(dev)
            counts[:2] = torch.tensor([K, 0], device=dev)
            masks = {"full": None,
                     "ragged": torch.arange(K, device=dev)[None, :] < counts[:, None],
                     "all-masked": torch.zeros(32, K, dtype=torch.bool, device=dev)}
            for dt in (torch.float32, torch.bfloat16):
                x = pts.to(dt)
                for mname, mask in masks.items():
                    what = f"din {din} K {K} {str(dt)[6:]} {mname}"
                    got = fused_st_forward(st_model, x, mask)
                    torch.cuda.synchronize()
                    worst["plain"] = max(worst["plain"], k1_check(
                        got, fused_st_forward_plain(st_model, x, mask), what))
                    worst["f32"] = max(worst["f32"], k1_check(
                        got, st_model(x.float(), mask), f"{what} vs the f32 ST",
                        tol=ST_F32_TOL))
    errs["fused_st_forward"] = max(errs["fused_st_forward"], worst["plain"])
    log(f"[K1] K in {K1_POINTS} x din 2, 3 x f32, bf16 points x full, ragged, "
        f"all-masked (32 clouds each): max |err| {worst['plain']:.3e} against "
        f"the plain version, {worst['f32']:.3e} against the f32 ST "
        f"({time.perf_counter() - t0:.1f} s)")
    # K1's scratch form, past the shared-memory form's limit: the full
    # 5,120-point grids of top_k=None serving, with and without a ragged
    # mask (one cloud full, one empty), f32 and bf16 points
    t0 = time.perf_counter()
    worst_s = 0.0
    for K in K1_SCRATCH_POINTS:
        check(K > max_points(64), f"K1 scratch: {K} points fit the shared form")
        pts = torch.from_numpy(rng.standard_normal((16, K, 3)).astype(
            np.float32)).to(dev)
        counts = torch.from_numpy(rng.integers(0, K + 1, 16)).to(dev)
        counts[:2] = torch.tensor([K, 0], device=dev)
        for mname, mask in (("full", None), ("ragged", torch.arange(
                K, device=dev)[None, :] < counts[:, None])):
            for dt in (torch.float32, torch.bfloat16):
                before = launch_scratch.launches
                got = fused_st_forward(model, pts.to(dt), mask)
                torch.cuda.synchronize()
                check(launch_scratch.launches == before + 1,
                      f"K1 K {K}: the scratch form was not launched")
                worst_s = max(worst_s, k1_check(
                    got, fused_st_forward_plain(model, pts.to(dt), mask),
                    f"scratch form K {K} {str(dt)[6:]} {mname}"))
    errs["fused_st_scratch"] = worst_s
    log(f"[K1] scratch form, K in {K1_SCRATCH_POINTS} x f32, bf16 points x "
        f"full, ragged (16 clouds each): max |err| {worst_s:.3e} against the "
        f"plain version (bar {K1_TOL} abs + rel) ({time.perf_counter() - t0:.1f} s)")
    fst = ST(dim_input=2, dim_output=10, num_inds=64, dim_hidden=64,
             num_heads=8)
    fst.load_state_dict(load_reference_pth(FST_PTH))
    fst = fst.to(dev).eval()
    pts = torch.from_numpy(rng.uniform(-1, 1, (512, 1025, 2)).astype(
        np.float32)).to(dev)
    counts = torch.from_numpy(rng.integers(0, 1026, 512)).to(dev)
    counts[:2] = torch.tensor([1025, 0], device=dev)
    mask = torch.arange(1025, device=dev)[None, :] < counts[:, None]
    fused_st_forward.launches = 0
    got = fused_st_forward(fst, pts, mask)
    torch.cuda.synchronize()
    check(fused_st_forward.launches == 1, "K1 FST: the 1025-point frames did "
          "not go through the kernel")
    ref = fused_st_forward_plain(fst, pts, mask)
    # the trained checkpoint's bf16 function is ill-conditioned on a few
    # frames (logits beyond 100; a rounding that flips either way moves
    # them): held to the JAX tests' bar
    fst_err = k1_check(got, ref, "FST checkpoint, 1025 points, ragged",
                       tol=JAX_K1_TOL)
    # this trained checkpoint's bf16 function itself (the plain version)
    # sits beyond the 5e-2 bar from the f32 ST on some frames; K1 may sit
    # no further than 1.25 x as far
    f32 = fst(pts, mask)
    bar = ST_F32_TOL + ST_F32_TOL * f32.abs()
    plain_rel = ((ref - f32).abs() / bar).max().item()
    k1_rel = ((got - f32).abs() / bar).max().item()
    check(k1_rel <= 1.25 * max(plain_rel, 1.0), f"K1 FST: {k1_rel:.3f} x the "
          f"f32 bar against the plain version's {plain_rel:.3f} x")
    log(f"[K1] FST checkpoint, 512 frames of 1025 points, ragged mask (incl. "
        f"an all-masked frame): max |err| {fst_err:.3e} against the plain "
        f"version (bar {JAX_K1_TOL} abs + rel); against the f32 ST max |err| {(got - f32).abs().max().item():.3e}"
        f" = {k1_rel:.3f} x the {ST_F32_TOL} bar (the plain version: "
        f"{plain_rel:.3f} x; max |logit| {f32.abs().max().item():.1f})")
    errs["fused_st_forward"] = max(errs["fused_st_forward"], fst_err)
    del grids, cloud, got, ref

    # ---- 3. the slice: AudioClassifier answers three requests ---------------
    phase("3. the slice: AudioClassifier answers three requests")
    clf = AudioClassifier(model=model, pipeline=CFG, batch_size=64,
                          buffer_len=L, device="cuda")
    plain_clf = AudioClassifier(model=model, pipeline=CFG, batch_size=64,
                                buffer_len=L, device="cuda", plain=True)
    requests = []
    for n in (64, 17, 100):
        wr, _ = synthetic_waves(n, rng)
        lens = rng.integers(FS // 2, 220500, n)
        requests.append([wr[i, :lens[i]] for i in range(n)])
    for k in SERVE_KERNELS:
        KERNELS[k][0].launches = 0
    served = [clf.logits(req) for req in requests]
    torch.cuda.synchronize()
    launches = {k: KERNELS[k][0].launches for k in SERVE_KERNELS}
    log(f"[serve] launches in the three requests: {launches}")
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched on the main path")
    for req, lg in zip(requests, served):
        check(lg.shape == (len(req), 10), f"served logits shape {lg.shape}")
        check(bool(np.isfinite(lg).all()), "served logits not finite")
        ref = plain_clf.logits(req)
        agree, decided, ldev = tie_aware_argmax(torch.from_numpy(lg),
                                                torch.from_numpy(ref))
        log(f"[serve] {len(req)} clips: labels {lg.argmax(-1).tolist()}")
        log(f"[serve] {len(req)} clips: argmax agrees with the plain path on "
            f"{agree}/{len(req)} ({decided} decided rows all agree), "
            f"max logit dev {ldev:.3e}")

    serve_paths_phase(model, requests, served, launches, name_limit)

    # ---- 4. timings at the bench shape --------------------------------------
    # phase 12's training runs share the card and the host: they end
    # before anything is timed
    waited = wait_job(tasks_job[0], "the tasks' training runs", tasks_job[2])
    log(f"[tasks] phase 12's training runs ended {waited:.1f} s after phase 3")
    phase("4. timings at the bench shape")
    gen = torch.Generator(dev).manual_seed(0)
    bw = 0.1 * torch.randn(BENCH_B, L, device=dev, generator=gen)
    bl = torch.full((BENCH_B,), 220500, dtype=torch.int32, device=dev)
    times, bounds, lib_ms = {}, {}, {}
    times["fused_chunk_mag2"] = paired_ms(
        lambda: fused_chunk_mag2(bw, bl, out_dtype=torch.bfloat16),
        lambda: fused_chunk_mag2_plain(bw, bl, out_dtype=torch.bfloat16), 10, 3)
    grid, gmask = fused_chunk_mag2(bw, bl, out_dtype=torch.bfloat16)
    n_frames = BENCH_B * grid.shape[1] * grid.shape[2]
    # a real FFT of n points: 2.5·n·log2(n) f32 operations
    bounds["fused_chunk_mag2"] = bound_ms(
        {"f32": 2.5 * N_FFT * np.log2(N_FFT) * n_frames}, nbytes(bw, bl, grid, gmask))
    # yardstick: torch.fft.rfft of the same Hann-windowed frames (reflect
    # padded, hop 512, no trim), then |X|²
    frames = (F.pad(bw[:, None], (HOP, HOP), mode="reflect")[:, 0]
              .unfold(-1, N_FFT, HOP)[:, :grid.shape[1] * grid.shape[2]]
              * torch.hann_window(N_FFT, periodic=True, device=dev))

    def rfft_mag2():
        X = torch.fft.rfft(frames)
        return X.real.square() + X.imag.square()
    lib_ms["fused_chunk_mag2"] = cuda_ms(rfft_mag2, 10)
    del frames
    torch.cuda.empty_cache()
    trim_ms, frames_ms = k3_launch_ms(bw, bl)
    log(f"[time] K3 noise B={BENCH_B}: trim_bounds_kernel {trim_ms:.4f} ms + "
        f"frames_mag2_kernel {frames_ms:.4f} ms of device time a call "
        f"(torch.profiler); bound {bounds['fused_chunk_mag2'][0]:.3f} ms, "
        f"{bound_ms({}, nbytes(bw, bl, grid, gmask, bw))[0]:.3f} ms with the "
        f"trim pass's own read of the waves ({name_limit})")
    # K3 a second way: ragged lengths and trimmed lead-ins at the bench shape
    rw, rl = (torch.from_numpy(a).to(dev)
              for a in ragged_waves(BENCH_B, np.random.default_rng(7)))
    rag_ms = paired_ms(
        lambda: fused_chunk_mag2(rw, rl, out_dtype=torch.bfloat16),
        lambda: fused_chunk_mag2_plain(rw, rl, out_dtype=torch.bfloat16), 10, 3)
    rtrim_ms, rframes_ms = k3_launch_ms(rw, rl)
    rg, rgm = fused_chunk_mag2(rw, rl, out_dtype=torch.bfloat16)
    rr, rrm = fused_chunk_mag2_plain(rw, rl, out_dtype=torch.bfloat16)
    rag_err, rag_rel = k3_check(rg, rgm, rr, rrm, torch.bfloat16, "ragged")
    log(f"[time] K3 ragged B={BENCH_B} (synthetic_waves, lengths 0.5-5 s, "
        f"half led in by trimmed near-silence; {int(rrm.sum())}/{rrm.numel()} "
        f"valid chunks): kernel {rag_ms[0]:.3f} ms, plain {rag_ms[1]:.3f} ms; "
        f"trim_bounds_kernel {rtrim_ms:.4f} ms + frames_mag2_kernel "
        f"{rframes_ms:.4f} ms of device time; bf16 max |err| {rag_err:.3e} "
        f"(rel to chunk max {rag_rel:.3e}) ({name_limit})")
    del rw, rl, rgm, rr, rrm
    torch.cuda.empty_cache()
    grid = grid.reshape(-1, 10, 512)
    times["exact_topk_chunks"] = paired_ms(
        lambda: exact_topk_chunks(grid, TOP_K),
        lambda: exact_topk_chunks_plain(grid, TOP_K), 10, 3)
    bounds["exact_topk_chunks"] = bound_ms({}, nbytes(grid, *exact_topk_chunks(grid, TOP_K)))
    # yardstick: torch.topk of each flattened chunk (its tie order differs)
    flat = grid.reshape(grid.shape[0], -1)
    lib_ms["exact_topk_chunks"] = cuda_ms(lambda: torch.topk(flat, TOP_K), 10)

    def k2_time(label, m, k):
        v, i = exact_topk_chunks(m, k)
        rv, ri = exact_topk_chunks_plain(m, k)
        check(torch.equal(i, ri) and torch.equal(v, rv),
              f"K2 {label} at the bench shape, K {k}: differs from the plain version")
        del v, i, rv, ri
        ms = cuda_ms(lambda: exact_topk_chunks(m, k), 10)
        b = bound_ms({}, nbytes(m) + m.shape[0] * k * 8.0)[0]
        log(f"[time] K2 {label}, {m.shape[0]} chunks of 10 x 512 "
            f"{str(m.dtype)[6:]}, K {k} (identical to the plain version): {ms:.4f} ms, bound {b:.4f} ms by bytes "
            f"({name_limit})")
    # K2 on the other grids serving sends it, and at other K
    for k in (256, 5120):
        k2_time("noise", grid, k)
    g32 = fused_chunk_mag2(bw, bl, out_dtype=torch.float32)[0].reshape(-1, 10, 512)
    k2_time("noise", g32, TOP_K)
    del g32
    k2_time("ragged (K3 of ragged_waves)", rg.reshape(-1, 10, 512), TOP_K)
    del rg
    ties = (torch.floor(torch.rand(grid.shape, device=dev, generator=gen) * 16) / 4
            ).bfloat16()
    k2_time("tie-heavy (16 levels)", ties, TOP_K)
    del ties
    cloud, _ = extract_chunk_clouds(bw, bl, CFG)
    pts = cloud.points
    del grid, flat, cloud
    torch.cuda.empty_cache()
    # the plain ST holds a few [N, 8, 128, 64] f32 attention tensors
    free, _ = torch.cuda.mem_get_info()
    fits = 3 * pts.shape[0] * 8 * 128 * 64 * 4 < 0.6 * free
    plain_b = BENCH_B if fits else 256
    if not fits:
        log(f"[time] the plain ST does not fit at {pts.shape[0]} clouds: the "
            f"ST and the plain e2e path are timed at B={plain_b}")
    sp = pts[:plain_b * 43].contiguous()
    times["fused_st_forward"] = paired_ms(
        lambda: fused_st_forward(model, sp, None),
        lambda: fused_st_forward_plain(model, sp, None), 5, 2)
    # K1's products run on bf16 tensor cores, its softmax exps on the SFU;
    # the slower of the two bounds it.  No one library call is an ST.
    bounds["fused_st_forward"] = k1_bound(sp, model)
    lib_ms["fused_st_forward"] = None
    w_k1 = _packed_weights(model, dev)
    out_k1 = torch.empty(sp.shape[0], 10, device=dev)
    split = [cuda_ms(lambda: launch_packed(sp, None, w_k1, out_k1, 64, p), 5)
             for p in (1, 2, 3)]
    log(f"[time] K1 B={plain_b} x {sp.shape[1]} points, stage split (launches "
        f"cut after pass 1, 2, 3): ISAB 1 MAB0 {split[0]:.3f} ms, ISAB 1 MAB1 "
        f"+ ISAB 2 MAB0 {split[1] - split[0]:.3f} ms, ISAB 2 MAB1 + PMA + "
        f"Linear {split[2] - split[1]:.3f} ms ({name_limit})")
    del pts, sp, out_k1
    torch.cuda.empty_cache()
    # K1 at the serving default's 256 points a cloud, the same clips
    cfg256 = dataclasses.replace(CFG, top_k=256)
    sp = extract_chunk_clouds(bw, bl, cfg256)[0].points
    k256_ms = cuda_ms(lambda: fused_st_forward(model, sp, None), 5)
    b256 = k1_bound(sp, model)
    log(f"[time] K1 at top-K 256: {sp.shape[0]} clouds of {sp.shape[1]} "
        f"points {k256_ms:.3f} ms, bound {b256[0]:.3f} ms by {b256[1]} "
        f"({name_limit})")
    del sp
    torch.cuda.empty_cache()
    k1_scratch_time(model, bw[:64], bl[:64], times, bounds, lib_ms, name_limit)
    e2e = make_temporal_classifier(model, CFG, use_fused_st=True)
    e2e_plain = make_temporal_classifier(model, CFG, use_fused_st=True,
                                         plain=True)
    e2e_ms = cuda_ms(lambda: e2e(bw, bl), 5)
    e2e_plain_ms = cuda_ms(lambda: e2e_plain(bw[:plain_b], bl[:plain_b]), 2)
    per, idle = profile_device(lambda: e2e(bw, bl), 3)
    log(f"[profile] e2e B={BENCH_B}, device ms a call by kernel (torch.profiler, "
        f"3 calls): " + "; ".join(f"{k[:60]} {v:.4f}" for k, v in
                                 list(per.items())[:6])
        + f"; all {sum(per.values()):.4f}; device idle share {idle:.4f} "
        f"({name_limit})")
    for k, (ms, plain_ms) in times.items():
        b = plain_b if k == "fused_st_forward" else BENCH_B
        lib = "none" if lib_ms[k] is None else f"{lib_ms[k]:.3f} ms"
        log(f"[time] {k}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
            f"{lib}, bound {bounds[k][0]:.3f} ms by {bounds[k][1]} "
            f"(B={b} x 5 s; {name_limit})")
    log(f"[time] e2e: kernels B={BENCH_B} {e2e_ms:.3f} ms = "
        f"{BENCH_B / e2e_ms * 1e3:.1f} clips/s, plain B={plain_b} "
        f"{e2e_plain_ms:.3f} ms = {plain_b / e2e_plain_ms * 1e3:.1f} clips/s "
        f"({name_limit})")
    # the xla featurize path (rfft STFT, one flat stable top-K, then K1)
    # beside the fused one, in turns; and full-grid serving on 64 clips
    e2e_xla = make_temporal_classifier(
        model, dataclasses.replace(CFG, featurize="xla"), use_fused_st=True)
    xla_ms, fused_ms = paired_ms(lambda: e2e_xla(bw, bl), lambda: e2e(bw, bl), 3, 3)
    log(f"[time] e2e B={BENCH_B}, top_k {TOP_K}: xla featurize {xla_ms:.3f} ms = "
        f"{BENCH_B / xla_ms * 1e3:.1f} clips/s, fused {fused_ms:.3f} ms = "
        f"{BENCH_B / fused_ms * 1e3:.1f} clips/s ({name_limit})")
    full_ms = {fz: cuda_ms(lambda fz=fz: make_temporal_classifier(
        model, dataclasses.replace(CFG, featurize=fz, top_k=None),
        use_fused_st=True)(bw[:64], bl[:64]), 3) for fz in ("fused", "xla")}
    log(f"[time] e2e B=64, top_k None ({FULL_POINTS} points a cloud, K1's "
        f"scratch form): fused featurize {full_ms['fused']:.3f} ms, xla "
        f"{full_ms['xla']:.3f} ms = {64 / full_ms['fused'] * 1e3:.1f} / "
        f"{64 / full_ms['xla'] * 1e3:.1f} clips/s ({name_limit})")
    del bw, bl, e2e, e2e_plain, clf, plain_clf
    torch.cuda.empty_cache()

    # ---- 5. K4 vs its plain pair at the recipes' attends --------------------
    phase("5. K4 vs its plain pair at the recipes' attends")
    gen = torch.Generator(dev).manual_seed(5)
    k4_fwd_err = k4_bwd_err = 0.0
    cases = ([(128, N, M, {}) for N, M in FST_ATTENDS.values()]
             + [(16, N, M, {}) for N, M in ST3_ATTENDS.values()]
             + [(6, 64, 300, {"ragged": True}), (6, 300, 9, {"ragged": True}),
                (6, 1, 37, {"ragged": True})]
             # expt 2's rank masks at the FST attends that take the mask
             + [(128, N, 1025, {"keep": K}) for N in (64, 1) for K in (1, 501, 1025)]
             # logits 64 x randn's
             + [(128, N, M, {"mag": 8.0}) for N, M in FST_ATTENDS.values()])
    for B, N, M, kw in cases:
        f_err, b_err = k4_check(B, N, M, gen, **kw)
        k4_fwd_err, k4_bwd_err = max(k4_fwd_err, f_err), max(k4_bwd_err, b_err)
        log(f"[K4] B={B} {N} queries x {M} keys {kw or ''}: out max |err| "
            f"{f_err:.3e}, dq/dk/dv max |err| {b_err:.3e}")
    errs["fused_mha_fwd"], errs["fused_mha_bwd"] = k4_fwd_err, k4_bwd_err

    # ---- 6. training through the CLI ----------------------------------------
    phase("6. training through the CLI")
    work = tempfile.mkdtemp(prefix="pcaudio_smoke_")
    base_dir = tempfile.mkdtemp(prefix="pcaudio_baselines_")
    atexit.register(shutil.rmtree, base_dir, True)
    try:
        train_out = train_phase(work, dev, train_job)
        # ---- 11, first half: the baselines trained on phase 6's corpus -----
        phase("11, first half: the baselines trained on phase 6's corpus")
        base_dirs = baselines_train_phase(train_out["corpus"], base_dir, dev,
                                          name_limit)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches.update(train_out["launches"])

    # ---- 7. K4 and the recipe steps, timed ------------------------------------
    phase("7. K4 and the recipe steps, timed")
    scale = 1.0 / DV ** 0.5
    k4_ms = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    k4_lib = {"fwd": 0.0, "bwd": 0.0}
    # fwd: exps, the 3xTF32 products' flops (three passes), bytes; bwd: the
    # same three (k4_stages.bwd_work: five products with S recomputed)
    k4_work = {"fwd": [0.0, 0.0, 0.0], "bwd": [0.0, 0.0, 0.0]}
    for name, (N, M) in FST_ATTENDS.items():
        q, k, v, _, g = mha_inputs(128, N, M, gen)
        out, lse = fused_mha_fwd(q, k, v, None, HEADS, scale)
        n = FST_STEP_ATTENDS[name]
        # fwd: one exp a score, Q·Kᵀ and A·V; each tensor read or written once
        k4_work["fwd"][0] += n * 128.0 * HEADS * N * M
        k4_work["fwd"][1] += n * 3 * 4.0 * 128 * N * M * DV
        k4_work["fwd"][2] += n * nbytes(q, k, v, out, lse)
        k4_work["bwd"] = [a + n * b for a, b in zip(k4_work["bwd"], bwd_work(128, N, M))]
        fwd, lib_f, bwd, lib_b = k4_attend_times(q, k, v, out, lse, g, 20)
        k4_lib["fwd"] += n * lib_f
        k4_lib["bwd"] += n * lib_b
        for key, t in (("fwd", fwd), ("bwd", bwd)):
            for i in range(2):
                k4_ms[key][i] += n * t[i]
        log(f"[time] K4 FST {name} B=128 {N}x{M}: fwd kernel {fwd[0]:.3f} ms, "
            f"plain {fwd[1]:.3f} ms, sdpa {lib_f:.3f} ms; bwd kernel {bwd[0]:.3f} "
            f"ms, plain {bwd[1]:.3f} ms, sdpa {lib_b:.3f} ms "
            f"({bwd_plan(128, N, M, HEADS, _sm_count(0)).kind}) ({name_limit})")
    for key in ("fwd", "bwd"):
        times[f"fused_mha_{key}"] = tuple(k4_ms[key])
        lib_ms[f"fused_mha_{key}"] = k4_lib[key]
    # the forward: its exps on the SFU, its 3xTF32 products on the tensor
    # cores, or its bytes, whichever takes longest; the backward likewise
    for key in ("fwd", "bwd"):
        bounds[f"fused_mha_{key}"] = bound_ms(
            {"sfu": k4_work[key][0], "tf32": k4_work[key][1]}, k4_work[key][2])
    log(f"[time] K4 over one FST step's five attends: fwd kernel "
        f"{k4_ms['fwd'][0]:.3f} ms, plain {k4_ms['fwd'][1]:.3f} ms, sdpa "
        f"{k4_lib['fwd']:.3f} ms, bound {bounds['fused_mha_fwd'][0]:.3f} ms by "
        f"{bounds['fused_mha_fwd'][1]}; bwd kernel {k4_ms['bwd'][0]:.3f} ms, "
        f"plain {k4_ms['bwd'][1]:.3f} ms, sdpa {k4_lib['bwd']:.3f} ms, bound "
        f"{bounds['fused_mha_bwd'][0]:.4f} ms by {bounds['fused_mha_bwd'][1]} "
        f"({name_limit}); the forward's bound parts: {k4_fwd_parts(*k4_work['fwd'])}; "
        f"the backward's: {bwd_parts(*k4_work['bwd'])}")
    k4_3st_bwd_time(gen, name_limit)
    k4_eval_time(gen, name_limit)
    for tag, (cfg, batch) in train_out["batches"].items():
        steps = {}
        for fused in (True, False):
            state, apply_fn = build_trainer(cfg, dev, fused_attn=fused)
            state.model.load_state_dict(train_out["weights"][tag])
            steps[fused] = make_train_step(apply_fn, state.optimizer)
        k_ms, p_ms = paired_ms(lambda: steps[True](batch),
                               lambda: steps[False](batch), 20, 20)
        n = cfg.batch_size
        log(f"[time] {tag} recipe step (fwd + bwd + Adam), batch {n} x "
            f"{batch['points'].shape[1]} points: kernel path {k_ms:.3f} ms = "
            f"{n / k_ms * 1e3:.1f} clouds/s, plain path {p_ms:.3f} ms = "
            f"{n / p_ms * 1e3:.1f} clouds/s ({name_limit})")
        step_profile(tag, lambda: steps[True](batch), name_limit)
    remat_phase(train_out, dev, name_limit)

    # ---- 8. the probes at their TPU scripts' shapes ---------------------------
    phase("8. the probes at their TPU scripts' shapes")
    eval_work = tempfile.mkdtemp(prefix="pcaudio_eval_")
    atexit.register(shutil.rmtree, eval_work, True)
    corpus_job = start_corpus(os.path.join(eval_work, "corpus"), 40)
    # each probe is its own path: a probe kernel's count starts at 0 before
    # its timed launches and is read after them (timing.measure)
    probe_rows = []
    for name, probe in PROBES.items():
        t0 = time.perf_counter()
        res = probe.run("cuda", seed=0)
        for case, r in res.items():
            check(r["launches"] > 0, f"probe {name} {case}: no launch of {r['kernel']}")
            log(f"[probe] {name} {case}: {describe(r)} ({name_limit})")
            probe_rows.append(
                {"name": f"{r['kernel']} [{name}: {case}]", "route": r["route"],
                 "source": r["source"], "replaces": r["replaces"],
                 "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                 "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        for line in probe.summary(res):
            log(f"[probe] {name}: {line} ({name_limit})")
        log(f"[probe] {name}: {time.perf_counter() - t0:.1f} s")
        del res
        torch.cuda.empty_cache()
    # the redesigns of P1, P2, P3, P4a, P6a, P8 and P9 beside their earlier
    # design, in this process: ms, the library call, the bound, rates and %
    # of peak
    t0 = time.perf_counter()
    old = probe_stages.finish_old_builds(old_jobs)
    probe_stages.compare(dev, old, name_limit)
    for line in wgmma_report(sass_job):
        log(f"[probe] {line}")
    log(f"[probe] old against new: {time.perf_counter() - t0:.1f} s")
    # ---- 9. the serving ingest: WAV files through classify_paths -----------
    phase("9. the serving ingest: WAV files through classify_paths")
    ingest_phase(name_limit, ingest_job)
    # ---- 10. the paper's evaluation: cli eval through K4 --------------------
    phase("10. the paper's evaluation: cli eval through K4")
    launches["fused_mha_fwd"] += eval_phase(name_limit, base_dirs, eval_work,
                                            corpus_job)
    # ---- 12. the Set Transformer's tasks ----------------------------------
    phase("12. the Set Transformer's tasks")
    tasks_phase(tasks_job, grads_job, name_limit)
    log(f"[done] {time.perf_counter() - T_START:.1f} s")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": times[k][0], "plain_ms": times[k][1], "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1], "library_ms": lib_ms[k]}
        for k, (_, src, rep) in KERNELS.items()] + probe_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
