"""Profiling and timing helpers (counterpart of
``pcaudio/utils/profiling.py``): a device sync, a wall-clock timer and a
``torch.profiler`` trace.  Kernel times on the card come from CUDA events
(``pcaudio_torch.probes.timing.cuda_ms``); device time by kernel and the
idle share from ``probes.timing.profile_device``."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Tuple

import torch

from pcaudio_torch.utils.debugging import _leaves


def device_sync(tree) -> None:
    """Wait for the device of the first tensor in ``tree`` (nested dicts,
    lists and tuples): ``torch.cuda.synchronize`` on a CUDA tensor; CPU
    tensors are ready when returned."""
    for _, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


def time_fn(fn: Callable, *args, iters: int = 10,
            warmup: int = 1) -> Tuple[float, object]:
    """Wall-time ``fn(*args)`` with a device sync after the warm-up calls
    and after the timed ones; returns ``(seconds per call, last output)``,
    the JAX function's contract."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    device_sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    device_sync(out)
    return (time.perf_counter() - t0) / iters, out


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where there is a
    card), written as a Chrome trace ``log_dir/trace.json`` (open it in
    ``chrome://tracing`` or Perfetto); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
