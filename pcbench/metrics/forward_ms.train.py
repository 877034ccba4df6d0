"""Device ms a train step of the kernels inside ``train.forward``
(``train/step.py``): the model's forward and the loss."""
from pcbench.spans import device_ranges, device_s_within

SPAN = "train.forward"


def read(ctx):
    ranges = device_ranges(ctx.trace, (SPAN,))
    if not ranges or not ctx.counts["steps"]:
        return None
    return 1e3 * device_s_within(ctx.trace, ranges) / ctx.counts["steps"]
