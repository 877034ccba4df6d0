"""Per-layer readers, one file a metric (``<metric>.py``, a function
``read(ctx)`` that returns the number or None where the trace holds
nothing it reads), and what several of them share.  Each reader names the
kernels it reads: a kernel a later change renames is missing from its
list, and the reader then returns None rather than a wrong number."""
from __future__ import annotations

from pcbench.trace import kernel_base


def device_s(trace, names) -> float:
    """Device seconds of the kernels whose identifier is in ``names``."""
    return sum(e - s for n, s, e in trace.kernels if kernel_base(n) in names)


def present(trace, names) -> set:
    return {kernel_base(n) for n, _, _ in trace.kernels} & set(names)


def idle_pct(ctx):
    if ctx.window_s <= 0 or not ctx.trace.kernels:
        return None
    return 100.0 * max(0.0, 1.0 - ctx.busy_s / ctx.window_s)


def mean_ms(values):
    return 1e3 * sum(values) / len(values) if values else None


def affine(f):
    """``(a, b)`` of a count ``f(n) = a + b·n`` that is affine in ``n``."""
    a = f(0)
    return a, f(1) - a
