"""The share of the clouds handed to the ST (kernel K1, which runs every
chunk cloud) that are valid chunks, from the serving pipeline's own
counters (``eval/pipeline.py``)."""
from pcbench.spans import counters

VALID, RUN = "pipeline.clouds_valid", "pipeline.clouds_st"


def read(ctx):
    c = counters((VALID, RUN))
    if c is None or not c[RUN]:
        return None
    return 100.0 * c[VALID] / c[RUN]
