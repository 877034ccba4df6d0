"""The share of the points the sweep's cloud classifier runs that it
serves by replaying a CUDA graph, from the sweep's own counters
(``eval/experiments.py::make_cloud_classifier``): how often the graph
replay engages; every other point's forward is launched kernel by kernel."""
from pcbench.spans import counters

REPLAYED, RUN = "expt2.points_replayed", "expt2.points_run"


def read(ctx):
    c = counters((REPLAYED, RUN))
    if c is None or not c[RUN]:
        return None
    return 100.0 * c[REPLAYED] / c[RUN]
