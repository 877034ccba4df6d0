"""The share of the traced window in which no kernel or copy ran on the
device."""
from pcbench.metrics import idle_pct


def read(ctx):
    return idle_pct(ctx)
