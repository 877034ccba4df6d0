"""Batch serving through the temporal 3ST pipeline
(``pcaudio_torch/eval/pipeline.py::make_temporal_classifier``).

A closed loop of one client that keeps ``in_flight`` batches queued on the
card: it submits a batch, copies its clip logits to pinned host memory
behind it, and waits for the oldest batch's logits once ``in_flight`` are
out.  The device never waits for the client, so the cell runs above the
card's capacity: its end-to-end number is the clips classified over the
window, and a batch's time from submission to its logits on the host is a
per-layer reading.  The batches cycle over a pool made at set-up.

``correct``: every batch's clip logits against the plain reference's for
its pool batch (``reference/featurize.py``, ``reference/st.py``, each
product's operands rounded to the configuration's bf16, f32 sums), as the
widest gap over the batch's logits, divided by the RMS of the reference's.
"""
from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch

from pcbench import traffic
from pcbench.cell import Window, sync
from pcbench.program import build_st
from pcbench.reference.precision import PRECISIONS, tf32_off
from pcbench.weights import st_state_dict


class State:
    pass


def inputs(run) -> State:
    st = State()
    st.run = run
    st.params = st_state_dict(run.seed, run.config["model"], run.device)
    st.pool = traffic.clip_pool(run.seed, run.workload, run.device)
    pipe = run.config["pipeline"]
    hop, nt = pipe["n_fft"] // 2, pipe["num_frames"]
    st.chunks = (1 + run.workload["buffer_samples"] // hop) // nt
    # synthetic clips hold no silence, so the trim keeps each whole clip
    st.valid = [int(((1 + b["lengths"].long() // hop) // nt).clamp_max(st.chunks).sum())
                for b in st.pool]
    st.samples = [int(b["lengths"].long().sum()) for b in st.pool]
    st.outs = []
    return st


def setup(run) -> State:
    from pcaudio_torch.eval import pipeline

    st = inputs(run)
    run.mark("weights and traffic")
    st.model = build_st(run, st.params).eval()
    cfg = pipeline.TemporalPipelineConfig(**run.config["pipeline"])
    st.fn = pipeline.make_temporal_classifier(st.model, cfg,
                                              use_fused_st=run.config["use_fused_st"])
    for i in range(run.workload["warm_batches"]):
        b = st.pool[i % len(st.pool)]
        st.fn(b["waves"], b["lengths"])
    sync(run.device)
    run.mark("program built and warmed")
    return st


def window(st: State, seconds: float) -> Window:
    wl, run = st.run.workload, st.run
    depth, P, B = wl["in_flight"], len(st.pool), wl["clips"]
    ncls = run.config["model"]["num_classes"]
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
    ks = [k for k, _ in outs]
    counts = {"batches": n, "clips": n * B, "clouds": n * B * st.chunks,
              "valid_clouds": sum(st.valid[k] for k in ks),
              "wave_samples": sum(st.samples[k] for k in ks)}
    return Window(secs, i, i - n, {"serve_clips_per_s": n * B / secs}, counts,
                  {"dispatch": disp, "batch_latency": lat})


def release(st: State) -> None:
    st.fn = st.model = None
    gc.collect()
    if st.run.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_logits(st: State, k: int, rnd) -> np.ndarray:
    """The plain reference's clip logits of pool batch ``k``."""
    from pcbench.reference import featurize as rf
    from pcbench.reference.st import st_forward_blocks

    b = st.pool[k]
    clouds, valid = rf.serve_clouds(b["waves"], b["lengths"], st.run.config["pipeline"])
    logits = st_forward_blocks(st.params, clouds, None, st.run.config["model"]["num_heads"], rnd)
    return rf.clip_logits(logits, valid).cpu().numpy()


def logit_gap(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.sqrt(np.mean(ref.astype(np.float64) ** 2)))


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
