"""Profiling and timing helpers (counterpart of
``pcaudio/utils/profiling.py``): a device sync, a wall-clock timer, the
program's spans and counters, and a ``torch.profiler`` trace that records
them.  Kernel times on the card come from CUDA events
(``pcaudio_torch.probes.timing.cuda_ms``).

Spans and counters are on only while a ``torch.profiler`` records, and the
profiler is their only switch.  A span is a ``record_function`` range, so
it lands in the profiler's Chrome trace on the kernels' clock: on the host
as a ``user_annotation``, and on the device as a ``gpu_user_annotation``
from the first to the last kernel launched directly inside it (not inside a
nested span) from its own thread.  So a span with no nested span holds
exactly its kernels in its device range, and a device idle gap can be put
down to the innermost span running on the host.  Span names are fixed
strings: a request (a batch, a sweep call, a train step) is one instance
of its top-level span with what nests in it."""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, Tuple

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


_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_HOST: Dict[str, int] = {}
_DEVICE: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _recording() -> bool:
    # one C call (about 0.2 µs); an idle record_function costs about 11 µs
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared no-op context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to counter ``name`` while a profiler
    records."""
    if _recording():
        with _LOCK:
            _HOST[name] = _HOST.get(name, 0) + int(n)


def count_device(name: str, t: torch.Tensor) -> None:
    """Add ``t.sum()`` to counter ``name`` while a profiler records, as a
    device int64 scalar on ``t``'s device (no read back)."""
    if _recording():
        s = t.sum(dtype=torch.int64)
        key = (name, s.device)
        with _LOCK:
            total = _DEVICE.get(key)
            if total is None:
                _DEVICE[key] = s
            else:
                total.add_(s)


def counters() -> Dict[str, int]:
    """Every counter's total so far, ``{name: int}`` (each device total
    read once)."""
    with _LOCK:
        out = dict(_HOST)
        device = list(_DEVICE.items())
    for (name, _), total in device:
        out[name] = out.get(name, 0) + int(total)
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where there is a
    card), written as a Chrome trace ``log_dir/trace.json`` (open it in
    ``chrome://tracing`` or Perfetto) with the program's spans in it, and
    the counters of the block as ``log_dir/counters.json``; yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = counters()
    with profile(activities=activities) as prof:
        yield prof
    after = counters()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump({k: v - before.get(k, 0) for k, v in sorted(after.items())}, f,
                  indent=1)
