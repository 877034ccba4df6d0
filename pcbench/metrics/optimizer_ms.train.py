"""Device ms a step of the kernels inside PyTorch's own
``Optimizer.step#Adam.step`` range (``train/step.py``'s optimizer step)."""

RANGE = "Optimizer.step#Adam.step"


def read(ctx):
    spans = [(s, e) for n, s, e in ctx.trace.device_notes if n == RANGE]
    if not spans or not ctx.counts["steps"]:
        return None
    total = sum(e - s for _, s, e in ctx.trace.kernels
                if any(a <= s and e <= b for a, b in spans))
    return 1e3 * total / ctx.counts["steps"]
