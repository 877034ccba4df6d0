"""The program's own spans and counters in a traced window, as the
per-layer readers of ``program_span`` and ``program_counter`` metrics read
them.

A span of ``pcaudio_torch`` (``utils/profiling.py::span``) is a
``record_function`` range: the trace holds it on the host (``Trace.host``)
and, over the kernels launched directly inside it from its own thread, on
the device (``Trace.device_notes``).  Its counters count only while a
profiler records, and a run records only its traced window, so their
totals after the window are the window's.  Each reader names its spans and
counters as data and returns None where the trace or the program has none
of them (a program without spans).
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

Interval = Tuple[float, float]


def host_spans(trace, names: Iterable[str]) -> List[Interval]:
    """Host intervals of the spans named in ``names``, by start."""
    names = set(names)
    return sorted((s, e) for n, s, e in trace.host if n in names)


def device_ranges(trace, names: Iterable[str]) -> List[Interval]:
    """Device ranges of the spans named in ``names``, by start."""
    names = set(names)
    return sorted((s, e) for n, s, e in trace.device_notes if n in names)


def _inside(ranges: List[Interval], s: float, e: float) -> bool:
    i = bisect.bisect_right(ranges, (s, float("inf"))) - 1
    return i >= 0 and e <= ranges[i][1]


def device_s_within(trace, ranges: List[Interval]) -> float:
    """Device seconds of the kernels that lie inside one of ``ranges``
    (sorted by start, not overlapping)."""
    return sum(e - s for _, s, e in trace.kernels if _inside(ranges, s, e))


def idle_gaps(trace, min_s: float = 2e-6) -> List[Interval]:
    """The device's idle gaps between its activities, as
    ``Trace.idle_gaps`` finds them."""
    out, reach = [], None
    for _, s, e in trace.kernels:
        if reach is not None and s - reach >= min_s:
            out.append((reach, s))
        reach = e if reach is None else max(reach, e)
    return out


def idle_s_under(trace, spans: List[Interval]) -> float:
    """Idle device seconds of the gaps whose midpoint lies inside one of the
    host ``spans`` (sorted by start, not overlapping)."""
    total = 0.0
    for a, b in idle_gaps(trace):
        mid = 0.5 * (a + b)
        if _inside(spans, mid, mid):
            total += b - a
    return total


def counters(names: Iterable[str]) -> Optional[Dict[str, int]]:
    """The program's totals of counters ``names``, or None where the program
    keeps no counters or lacks one of them."""
    from pcaudio_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    if read is None:
        return None
    got = read()
    if any(n not in got for n in names):
        return None
    return {n: got[n] for n in names}
