"""The traced run: ``torch.profiler`` over a window, read back from its
Chrome trace into plain lists, the device's busy time, and the breakdown
the result line carries.

The union of device intervals and the rule that drops the device ranges of
host annotations are copied from ``pcaudio_torch/probes/timing.py``
(``busy_time``, ``device_events``), so the yardstick does not move when
the program's probes do.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """What a traced window recorded, times in seconds from the trace's
    own origin.

    ``kernels``: ``[(name, start, end)]`` device activity (kernels, copies,
    sets), without the device ranges that mirror host annotations;
    ``device_notes``: those ranges (``Optimizer.step#Adam.step``, and the
    harness's own ``record_function`` spans); ``host``: ``[(name, start,
    end)]`` host operators and annotations."""

    def __init__(self, kernels, device_notes, host):
        self.kernels: List[Tuple[str, float, float]] = sorted(kernels, key=lambda e: e[1])
        self.device_notes: List[Tuple[str, float, float]] = device_notes
        self.host: List[Tuple[str, float, float]] = sorted(host, key=lambda e: e[1])

    @classmethod
    def from_chrome(cls, doc: dict) -> "Trace":
        kernels, notes, host = [], [], []
        for e in doc.get("traceEvents", []):
            if e.get("ph") != "X" or "dur" not in e:
                continue
            item = (e.get("name", ""), e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                kernels.append(item)
            elif cat == "gpu_user_annotation":
                notes.append(item)
            elif cat in ("cpu_op", "user_annotation"):
                host.append(item)
        names = {n for n, _, _ in notes}
        # a device range mirrors a host annotation of the same name
        kernels = [k for k in kernels if k[0] not in names]
        return cls(kernels, notes, host)

    def busy_s(self) -> float:
        return busy_time([(s, e) for _, s, e in self.kernels])

    def by_name(self) -> Dict[str, float]:
        """Device seconds summed by kernel name, largest first."""
        out: Dict[str, float] = {}
        for n, s, e in self.kernels:
            out[n] = out.get(n, 0.0) + (e - s)
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def idle_gaps(self, min_s: float = 2e-6) -> Dict[str, float]:
        """Idle device seconds between device activities, summed by the
        innermost host operator running at each gap's middle, largest
        first."""
        spans = sorted((s, e) for _, s, e in self.kernels)
        starts = [h[1] for h in self.host]
        out: Dict[str, float] = {}
        reach = None
        for s, e in spans:
            if reach is not None and s - reach >= min_s:
                mid = 0.5 * (s + reach)
                name = "(no host operator)"
                i = bisect.bisect_right(starts, mid) - 1
                for j in range(i, max(i - 400, -1), -1):
                    if self.host[j][2] >= mid:
                        name = self.host[j][0]
                        break
                out[name] = out.get(name, 0.0) + (s - reach)
            reach = e if reach is None else max(reach, e)
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def busy_time(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    busy, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy


def kernel_base(name: str) -> str:
    """The kernel's identifier without return type, namespaces, template
    arguments and parameters: ``void (anonymous namespace)::
    fused_st_kernel<3, 4>(...)`` → ``fused_st_kernel``."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""), maxsplit=1)[0]
    head = head.strip()
    return head.split()[-1].split("::")[-1] if head else name


@contextlib.contextmanager
def traced():
    """``torch.profiler`` (host and device) over the block; yields a list
    that holds the :class:`Trace` once the block has ended.  The Chrome
    trace goes through a file under ``TMPDIR``, removed after reading."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    box: List[Trace] = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield box
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="pcbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            box.append(Trace.from_chrome(json.load(f)))
    finally:
        os.unlink(path)


def breakdown(trace: Trace, top: int = 10) -> dict:
    return {"device_ops": [[n, s] for n, s in list(trace.by_name().items())[:top]],
            "idle_gaps": [[n, s] for n, s in list(trace.idle_gaps().items())[:top]]}
