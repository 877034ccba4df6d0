"""The share of the points the sweep's masked forwards run through the
model that their masks keep, from the sweep's own counters
(``eval/experiments.py``): every other point passes the per-point layers
for nothing."""
from pcbench.spans import counters

KEPT, RUN = "expt2.points_kept", "expt2.points_run"


def read(ctx):
    c = counters((KEPT, RUN))
    if c is None or not c[RUN]:
        return None
    return 100.0 * c[KEPT] / c[RUN]
