"""Device ms a train step of the backward (``train/step.py``): the kernels
after a step's ``train.forward`` device range and before its optimizer's
first device range (``train.optimizer``, or PyTorch's own
``Optimizer.step#...`` inside it).  The autograd engine launches the
backward's kernels from a thread of its own, outside the device range of
``train.backward``; on one stream, stream order is program order."""
import bisect

from pcbench.spans import device_ranges

FORWARD, OPTIMIZER, TORCH_STEP = "train.forward", "train.optimizer", "Optimizer.step#"


def read(ctx):
    tr = ctx.trace
    fwd = device_ranges(tr, (FORWARD,))
    opt = sorted(s for n, s, _ in tr.device_notes
                 if n == OPTIMIZER or n.startswith(TORCH_STEP))
    if not fwd or not opt or not ctx.counts["steps"]:
        return None
    starts = [s for _, s, _ in tr.kernels]
    total = 0.0
    for _, f_end in fwd:
        i = bisect.bisect_left(opt, f_end)
        if i == len(opt):
            continue
        o_start = opt[i]
        for _, s, e in tr.kernels[bisect.bisect_left(starts, f_end):
                                   bisect.bisect_left(starts, o_start)]:
            if e <= o_start:
                total += e - s
    return 1e3 * total / ctx.counts["steps"]
