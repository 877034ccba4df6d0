"""Idle device ms a train step while the host runs the step
(``train/step.py``): the idle gaps whose midpoint lies inside a
``train.step`` span.  Read under the profiler, which slows the host:
compare it between commits, not with untraced host times."""
from pcbench.spans import host_spans, idle_s_under

SPAN = "train.step"


def read(ctx):
    spans = host_spans(ctx.trace, (SPAN,))
    if not spans or not ctx.trace.kernels or not ctx.counts["steps"]:
        return None
    return 1e3 * idle_s_under(ctx.trace, spans) / ctx.counts["steps"]
