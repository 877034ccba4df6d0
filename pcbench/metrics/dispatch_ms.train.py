"""Host ms to enqueue one train step (``train/step.py``): the step call's
time, with at most ``in_flight`` steps queued ahead of the device."""
from pcbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx.host.spans.get("dispatch", []))
