"""Device ms a batch of the kernels inside the AST pipeline's
``pipeline.fbank`` span (``eval/pipeline.py``, ``dsp/fbank.py``): framing,
DC offset, pre-emphasis and window, the ``rfft``, the power, the mel
product, the log and the normalisation."""
from pcbench.spans import device_ranges, device_s_within

SPANS = ("pipeline.fbank",)


def read(ctx):
    ranges = device_ranges(ctx.trace, SPANS)
    if not ranges or not ctx.counts["batches"]:
        return None
    return 1e3 * device_s_within(ctx.trace, ranges) / ctx.counts["batches"]
