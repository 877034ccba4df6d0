"""Batch serving through the Audio Spectrogram Transformer pipeline
(``pcaudio_torch/eval/pipeline.py::make_spectrogram_classifier``): waves at
16 kHz → Kaldi log-mel grid → the AST in bf16, attention through kernel K5.

The same closed loop as ``drivers/serve.py``: one client keeps
``in_flight`` batches queued on the card, copies each batch's logits to
pinned host memory behind it, and waits for the oldest once ``in_flight``
are out; the batches cycle over a pool made at set-up.  The pool's clips
are ``traffic.clip_set``'s synthetic ESC-10 stand-ins at 44.1 kHz,
resampled once at set-up to 16 kHz by the reference's plain windowed sinc
(``reference/ast.py::resample``), as AST's recipe converts its audio before
featurizing.

``correct``: every batch's clip logits against the plain reference's for
its pool batch (``reference/ast.py``: its own fbank, then the model in f32
with each product's operands rounded to the configuration's bf16), as the
widest gap over the batch's logits divided by the RMS of the reference
logits' deviation from their batch mean: with random weights much of each
logit is the same for every clip, and an undivided RMS would let an error
hide there.
"""
from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch

from pcbench import traffic
from pcbench.cell import Window, sync
from pcbench.reference import ast as ra
from pcbench.reference.precision import PRECISIONS, tf32_off


class State:
    pass


def inputs(run) -> State:
    st = State()
    st.run = run
    wl, m = run.workload, run.config["model"]
    st.params = ra.state_dict(run.seed, m, run.device)
    st.pool = []
    for i in range(wl["pool"]):
        clips = traffic.clip_set(run.seed, 10 + i, wl["clips"], tuple(wl["clip_seconds"]),
                                 wl["source_samples"], run.device)
        waves = ra.resample(clips["waves"], traffic.FS, run.config["pipeline"]["fs"])
        lengths = (clips["lengths"].long() * run.config["pipeline"]["fs"]) // traffic.FS
        st.pool.append({"waves": waves[:, :wl["buffer_samples"]].contiguous(),
                        "lengths": lengths.clamp_max(wl["buffer_samples"]).to(torch.int32)})
    st.outs = []
    return st


def setup(run) -> State:
    # first, so that a program without the AST stops before any work
    from pcaudio_torch.eval import pipeline
    from pcaudio_torch.nn import AST

    st = inputs(run)
    run.mark("weights and traffic")
    m = run.config["model"]
    model = AST(num_mel_bins=m["num_mel_bins"], max_length=m["max_length"],
                patch=m["patch_size"], fstride=m["frequency_stride"], tstride=m["time_stride"],
                dim=m["hidden_size"], depth=m["num_hidden_layers"],
                heads=m["num_attention_heads"], mlp=m["intermediate_size"],
                num_labels=m["num_labels"], eps=m["layer_norm_eps"]).to(run.device)
    model.load_state_dict(st.params)
    cfg = pipeline.SpectrogramPipelineConfig(**run.config["pipeline"])
    st.fn = pipeline.make_spectrogram_classifier(model, cfg)
    del model
    for i in range(run.workload["warm_batches"]):
        b = st.pool[i % len(st.pool)]
        st.fn(b["waves"], b["lengths"])
    sync(run.device)
    run.mark("program built and warmed")
    return st


def window(st: State, seconds: float) -> Window:
    wl, run = st.run.workload, st.run
    depth, P, B = wl["in_flight"], len(st.pool), wl["clips"]
    ncls = run.config["model"]["num_labels"]
    cuda = run.device.type == "cuda"
    ring = [torch.empty((B, ncls), dtype=torch.float32, pin_memory=cuda)
            for _ in range(depth + 1)]
    pending, outs, lat, disp = collections.deque(), [], [], []
    t0 = time.perf_counter()
    t_last = t0
    i = 0

    def finish():
        nonlocal t_last
        k, t_sub, ev, buf = pending.popleft()
        if ev is not None:
            ev.synchronize()
        t_last = time.perf_counter()
        lat.append(t_last - t_sub)
        outs.append((k % P, buf.numpy().copy()))

    while time.perf_counter() - t0 < seconds:
        b = st.pool[i % P]
        a = time.perf_counter()
        logits = st.fn(b["waves"], b["lengths"])
        disp.append(time.perf_counter() - a)
        buf = ring[i % (depth + 1)]
        buf.copy_(logits, non_blocking=cuda)
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
        pending.append((i, a, ev, buf))
        i += 1
        if len(pending) >= depth:
            finish()
    while pending:
        finish()
    st.outs.extend(outs)
    n = len(outs)
    secs = t_last - t0
    counts = {"batches": n, "clips": n * B}
    return Window(secs, i, i - n, {"serve_clips_per_s": n * B / secs}, counts,
                  {"dispatch": disp, "batch_latency": lat})


def release(st: State) -> None:
    st.fn = None
    gc.collect()
    if st.run.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_logits(st: State, k: int, rnd) -> np.ndarray:
    """The plain reference's clip logits of pool batch ``k``."""
    b, pipe = st.pool[k], st.run.config["pipeline"]
    feats = ra.fbank(b["waves"], b["lengths"], pipe["num_mel_bins"], pipe["max_length"],
                     pipe["mean"], pipe["std"], pipe["fs"])
    return ra.ast_forward_blocks(st.params, feats, st.run.config["model"], rnd).cpu().numpy()


def logit_gap(got: np.ndarray, ref: np.ndarray) -> float:
    ref = ref.astype(np.float64)
    dev = ref - ref.mean(0)
    return float(np.abs(got - ref).max() / np.sqrt(np.mean(dev ** 2)))


def check(st: State):
    rnd = PRECISIONS[st.run.config["reference_precision"]]
    with tf32_off():
        refs = {k: reference_logits(st, k, rnd) for k in sorted({k for k, _ in st.outs})}
    gap = max((logit_gap(y, refs[k]) for k, y in st.outs), default=float("inf"))
    return [("logit_gap", gap, st.run.limits["logit_gap"])]


def control(run, precision: str, batches: int = 1):
    """The comparison's reading with the reference at ``precision`` in the
    program's place, on the first ``batches`` pool batches."""
    st = inputs(run)
    rnd = PRECISIONS[run.config["reference_precision"]]
    with tf32_off():
        gaps = [logit_gap(reference_logits(st, k, PRECISIONS[precision]),
                          reference_logits(st, k, rnd)) for k in range(batches)]
    return {"logit_gap": max(gaps)}
