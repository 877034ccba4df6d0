"""Idle device ms a sweep call while the host runs the call
(``eval/experiments.py``): the idle gaps whose midpoint lies inside an
``expt2.call`` span.  Read under the profiler, which slows the host:
compare it between commits, not with untraced host times."""
from pcbench.spans import host_spans, idle_s_under

SPAN = "expt2.call"


def read(ctx):
    spans = host_spans(ctx.trace, (SPAN,))
    if not spans or not ctx.trace.kernels or not ctx.counts["calls"]:
        return None
    return 1e3 * idle_s_under(ctx.trace, spans) / ctx.counts["calls"]
