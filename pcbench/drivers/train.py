"""The FST train step (``pcaudio_torch/train/step.py::make_train_step``
over ``train/glue.py::pointcloud_apply``, ``torch.optim.Adam`` with L2
weight decay, K4's forward and backward for every attend).

Set-up builds one step, drives it through its first ``checked_steps``
steps on distinct batches of the pool (they warm every kernel), notes the
loss of each, Adam's first gradient and the parameters they leave, and
hands the same step to the window.  The window dispatches steps back to
back over the pool with no read of the loss; it only waits for the step
``in_flight`` steps back to finish, so the host is at most that far ahead.

``correct``: the plain reference (``reference/train.py``) runs the same
first steps from the same weights and batches.  Compared: the first step's
loss (gap over the reference's); the first gradient's norm by the worst
leaf and the change's norm over the steps by the median leaf, each leaf's
gap of norms over the larger of the reference leaf's norm and the median
leaf's.  The change leaves out leaves whose reference gradient is under a
thousandth of the median leaf's (round-off alone would move them).
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
from pcbench.reference.train import train_steps
from pcbench.weights import st_state_dict


class State:
    pass


def inputs(run) -> State:
    st = State()
    st.run = run
    st.params = st_state_dict(run.seed, run.config["model"], run.device)
    st.pool = traffic.frame_pool(run.seed, run.workload, run.config["featurize"]["n_fft"],
                                 run.device)
    return st


def setup(run) -> State:
    from pcaudio_torch.train.glue import pointcloud_apply
    from pcaudio_torch.train.step import make_train_step

    st = inputs(run)
    run.mark("weights and traffic")
    opt_cfg = run.config["optimizer"]
    st.model = build_st(run, st.params)
    st.opt = torch.optim.Adam(st.model.parameters(), lr=opt_cfg["lr"],
                              weight_decay=opt_cfg["weight_decay"])
    st.step = make_train_step(pointcloud_apply(st.model), st.opt)
    names = {p: n for n, p in st.model.named_parameters()}
    beta1 = st.opt.param_groups[0]["betas"][0]
    st.losses, st.grad1 = [], None
    for s in range(run.workload["checked_steps"]):
        out = st.step(st.pool[s])
        st.losses.append(float(out["loss"]))
        if s == 0:  # Adam's first moment after one step is (1 - beta1)·g
            st.grad1 = {names[p]: st.opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - beta1)
                        for p in names}
    st.theta = {n: p.detach().clone() for n, p in st.model.named_parameters()}
    st.next = run.workload["checked_steps"]
    sync(run.device)
    run.mark("program built, first steps")
    return st


def window(st: State, seconds: float) -> Window:
    wl, dev = st.run.workload, st.run.device
    cuda = dev.type == "cuda"
    P, B = len(st.pool), wl["batch"]
    events = collections.deque()
    disp = []
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if len(events) >= wl["in_flight"]:
            events.popleft().synchronize()
        a = time.perf_counter()
        st.step(st.pool[st.next % P])
        disp.append(time.perf_counter() - a)
        st.next += 1
        n += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
    sync(dev)
    secs = time.perf_counter() - t0
    return Window(secs, n, 0, {"train_clouds_per_s": n * B / secs},
                  {"steps": n, "clouds": n * B}, {"dispatch": disp})


def release(st: State) -> None:
    st.model = st.opt = st.step = None
    gc.collect()
    if st.run.device.type == "cuda":
        torch.cuda.empty_cache()


def _norms(d):
    return {n: float(t.double().norm()) for n, t in d.items()}


def _gaps(got: dict, ref: dict, names):
    """Each leaf's gap of norms, over the larger of the reference leaf's
    norm and the median leaf's."""
    names = list(names)
    med = float(np.median([ref[n] for n in names]))
    return [abs(got[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names]


def numbers(losses, grad1, delta, ref_losses, ref_grad1, ref_delta):
    """The first step's loss gap, the worst leaf's first-gradient gap, and
    the median leaf's change gap over the steps (leaves left out where the
    reference gradient is under a thousandth of the median leaf's).  The
    later steps' losses and the worst leaf's change are not compared: Adam's
    first step is a sign step, round-off decides it on the few elements of
    nought gradient, and one small leaf or a later loss then reads as much
    as the control (PERF.md)."""
    g_ref = _norms(ref_grad1)
    med = float(np.median(list(g_ref.values())))
    moved = [n for n, g in g_ref.items() if g >= 1e-3 * med]
    return {
        "loss_gap": abs(losses[0] - ref_losses[0]) / max(abs(ref_losses[0]), 1e-30),
        "grad_gap": max(_gaps(_norms(grad1), g_ref, g_ref)),
        "change_gap": float(np.median(_gaps(_norms(delta), _norms(ref_delta), moved))),
    }


def _reference(st: State, rnd, batches=None):
    opt, m = st.run.config["optimizer"], st.run.config["model"]
    steps = st.run.workload["checked_steps"]
    losses, g1, theta = train_steps(st.params, batches or st.pool[:steps], m["num_heads"],
                                    opt["lr"], opt["weight_decay"], rnd=rnd)
    return losses, g1, {n: theta[n] - st.params[n] for n in theta}


def check(st: State):
    with tf32_off():
        ref = _reference(st, PRECISIONS[st.run.config["reference_precision"]])
    delta = {n: st.theta[n] - st.params[n] for n in st.theta}
    got = numbers(st.losses, st.grad1, delta, *ref)
    return [(k, v, st.run.limits[k]) for k, v in got.items()]


def control(run, precision: str):
    """The numbers with the reference in the program's place: at
    ``precision``, or, for ``"half"``, at f32 on the first half of each
    batch (half of the batch left out, the mean taken over the rest)."""
    st = inputs(run)
    steps = run.workload["checked_steps"]
    rnd = PRECISIONS[run.config["reference_precision"]]
    with tf32_off():
        ref = _reference(st, rnd)
        if precision == "half":
            half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in st.pool[:steps]]
            low = _reference(st, rnd, half)
        else:
            low = _reference(st, PRECISIONS[precision])
    return numbers(*low, *ref)
