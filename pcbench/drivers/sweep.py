"""The paper's experiment 2 on FST: point subsampling
(``pcaudio_torch/eval/experiments.py::framewise_expt2`` in mode "cloud",
the ST's attention through kernel K4).

Each call classifies one set of clips' valid frames under every mask of
the sweep: maxK and ``nruns`` randK masks at each K of the list, one
masked forward of every frame each.  Calls run back to back over a pool of
clip sets made at set-up, each with a seed of its own for its randK
draws, and each ends with its counts on the host.

``correct``: on two calls drawn from the seed (the first, and one of the
next two), (1) the accuracies the call returned against those its own
forwards' logits give (exact), and (2) a sample of its masked forwards
drawn from the seed, the fullest and the sparsest maxK among them, against
the plain reference's logits for the same frames and masks
(``reference/expt2.py``), as the widest gap over the logits divided by the
RMS of the reference's.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from pcbench import traffic
from pcbench.cell import Window, sync
from pcbench.program import build_st
from pcbench.reference import expt2 as rx
from pcbench.reference.precision import PRECISIONS, tf32_off
from pcbench.weights import derived_seed, st_state_dict, standardize_output


class State:
    pass


class Recorder:
    """The cloud classifier the sweep calls: counts the forwards, the
    clouds and the points each keeps, and holds the logits of the calls
    under check (no read of the device)."""

    def __init__(self, clf, list_K, nruns, n_points):
        self.clf, self.list_K, self.per = clf, list_K, nruns + 1
        self.n_points = n_points
        self.forwards = self.clouds = self.kept = 0
        self.in_call = 0
        self.keep = None

    def __call__(self, points, mask=None):
        out = self.clf(points, mask)
        j = (self.in_call % (len(self.list_K) * self.per)) // self.per
        self.forwards += 1
        self.in_call += 1
        self.clouds += points.shape[0]
        self.kept += points.shape[0] * min(self.list_K[j], self.n_points)
        if self.keep is not None:
            self.keep.append(out)
        return out


def inputs(run) -> State:
    st = State()
    st.run = run
    wl, fz = run.workload, run.config["featurize"]
    st.params = st_state_dict(run.seed, run.config["model"], run.device)
    st.pool = traffic.clip_pool(run.seed, wl, run.device)
    with tf32_off():
        standardize_output(st.params, _frames(st, 0)[0], run.config["model"]["num_heads"])
    st.list_K = wl.get("list_K") or rx.default_list_K(fz["n_fft"] // 2)
    st.nruns = wl["nruns"]
    st.calls = []
    return st


def call_seed(run, i: int) -> int:
    return derived_seed(run.seed, 3, i)


def setup(run) -> State:
    from pcaudio_torch.eval import experiments

    st = inputs(run)
    run.mark("weights and traffic")
    st.model = build_st(run, st.params).eval()
    n_points = run.config["featurize"]["n_fft"] // 2 + 1
    st.rec = Recorder(experiments.make_cloud_classifier(st.model), st.list_K, st.nruns, n_points)
    st.expt2 = experiments.framewise_expt2
    st.checked = {0, 1 + derived_seed(run.seed, 4) % 2}
    st.next = 0
    _call(st, 0, seed=derived_seed(run.seed, 5))  # warm-up, not checked
    sync(run.device)
    run.mark("program built and warmed")
    return st


def _call(st: State, k: int, seed: int):
    fz, b = st.run.config["featurize"], st.pool[k % len(st.pool)]
    st.rec.in_call = 0
    return st.expt2(None, st.rec, b["waves"], b["lengths"], b["labels"], mode="cloud",
                    fsog=fz["fs"], Nfft=fz["n_fft"], hf=fz["hop_factor"], tDb=fz["top_db"],
                    list_K=st.list_K, nruns=st.nruns, seed=seed, device=st.run.device)


def window(st: State, seconds: float) -> Window:
    rec = st.rec
    f0, c0, k0 = rec.forwards, rec.clouds, rec.kept
    t0 = time.perf_counter()
    t_end, n, disp = t0, 0, []
    while time.perf_counter() - t0 < seconds:
        i = st.next
        st.next += 1
        rec.keep = [] if i in st.checked else None
        a = time.perf_counter()
        rnd, mx = _call(st, i, call_seed(st.run, i))
        t_end = time.perf_counter()
        disp.append(t_end - a)
        n += 1
        if rec.keep is not None:
            st.calls.append((i, rec.keep, rnd, mx))
        rec.keep = None
    secs = t_end - t0
    clouds = rec.clouds - c0
    counts = {"calls": n, "forwards": rec.forwards - f0, "clouds": clouds,
              "kept_points": rec.kept - k0}
    return Window(secs, n, 0, {"sweep_clouds_per_s": clouds / secs}, counts,
                  {"call": disp})


def release(st: State) -> None:
    st.model = st.rec = st.expt2 = None
    gc.collect()
    if st.run.device.type == "cuda":
        torch.cuda.empty_cache()


def _frames(st: State, i: int):
    fz, b = st.run.config["featurize"], st.pool[i % len(st.pool)]
    return rx.valid_frames(b["waves"], b["lengths"], b["labels"], fz["n_fft"], fz["fs"])


def sample(st: State, i: int, rows: int):
    """The forwards ``(microbatch, index)`` of call ``i`` under check."""
    per = len(st.list_K) * (st.nruns + 1)
    mbs = -(-rows // rx.MICROBATCH)
    want = {(0, 0), (0, (len(st.list_K) - 1) * (st.nruns + 1))}
    g = np.random.default_rng(derived_seed(st.run.seed, 6, i))
    while len(want) < min(st.run.workload["checked_forwards"], per * mbs):
        want.add((int(g.integers(mbs)), int(g.integers(per))))
    return sorted(want)


def logit_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.pow(2).mean().sqrt())


def _accuracies(logits, labels, nK, R):
    """The dicts' numbers from the forwards' logits, as the sweep forms
    them: per K, maxK's accuracy, randK's mean and variance over runs."""
    n = labels.shape[0]
    per = nK * (R + 1)
    hits = np.zeros((nK, R + 1), dtype=np.int64)
    for f, y in enumerate(logits):
        mb, idx = divmod(f, per)
        lab = labels[mb * rx.MICROBATCH: mb * rx.MICROBATCH + y.shape[0]]
        hits[idx // (R + 1), idx % (R + 1)] += int((y.argmax(-1) == lab).sum())
    out = []
    for j in range(nK):
        acc = hits[j, 1:] / max(n, 1)
        out.append((float(hits[j, 0] / max(n, 1)), float(np.mean(acc)), float(np.var(acc))))
    return out


def check(st: State):
    R, nK = st.nruns, len(st.list_K)
    heads = st.run.config["model"]["num_heads"]
    count_gap, gap = 0.0, 0.0
    if not st.calls:
        return [("calls_unchecked", 1.0, 0.0)]
    with tf32_off():
        for i, logits, rnd, mx in st.calls:
            clouds, labels = _frames(st, i)
            per = nK * (R + 1)
            mbs = -(-clouds.shape[0] // rx.MICROBATCH)
            if len(logits) != per * mbs or sum(y.shape[0] for y in logits[::per]) != clouds.shape[0]:
                return [("forwards_missing", 1.0, 0.0)]
            acc = _accuracies(logits, labels, nK, R)
            for j, K in enumerate(st.list_K):
                got = (mx["data"][K][0], rnd["data"][K][0], rnd["data"][K][1])
                count_gap = max(count_gap, max(abs(a - b) for a, b in zip(got, acc[j])))
            ref = rx.masked_logits(st.params, clouds, call_seed(st.run, i), st.list_K, R,
                                   sample(st, i, clouds.shape[0]), heads,
                                   PRECISIONS[st.run.config["reference_precision"]])
            for (mb, f), y in ref.items():
                gap = max(gap, logit_gap(logits[mb * per + f], y))
    lim = st.run.limits
    return [("count_gap", count_gap, lim["count_gap"]), ("logit_gap", gap, lim["logit_gap"])]


def control(run, precision: str, calls: int = 1):
    """The logit gap with the reference at ``precision`` in the program's
    place, on the sampled forwards of the first ``calls`` calls."""
    st = inputs(run)
    heads = run.config["model"]["num_heads"]
    gap = 0.0
    with tf32_off():
        for i in range(calls):
            clouds, _ = _frames(st, i)
            fw = sample(st, i, clouds.shape[0])
            args = (st.params, clouds, call_seed(run, i), st.list_K, st.nruns, fw, heads)
            ref = rx.masked_logits(*args, rnd=PRECISIONS[run.config["reference_precision"]])
            low = rx.masked_logits(*args, rnd=PRECISIONS[precision])
            gap = max(gap, max(logit_gap(low[k], ref[k]) for k in ref))
    return {"logit_gap": gap}
