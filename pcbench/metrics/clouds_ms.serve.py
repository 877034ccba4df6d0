"""Device ms a batch of the kernels inside the serving pipeline's
``pipeline.clouds`` and ``pipeline.mean`` spans (``eval/pipeline.py``): the
log-magnitude of the winners, their coordinates and stack, the point mask,
and the chunk mean."""
from pcbench.spans import device_ranges, device_s_within

SPANS = ("pipeline.clouds", "pipeline.mean")


def read(ctx):
    ranges = device_ranges(ctx.trace, SPANS)
    if not ranges or not ctx.counts["batches"]:
        return None
    return 1e3 * device_s_within(ctx.trace, ranges) / ctx.counts["batches"]
