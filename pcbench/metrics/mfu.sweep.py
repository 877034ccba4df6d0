"""The ST's FLOPs of the sweep's masked forwards, each frame counted at its
kept points, over the untraced window before the trace, as a share of the
TF32 peak."""
from pcbench import roofline as rf
from pcbench.metrics import affine


def read(ctx):
    m = ctx.config["model"]
    a, b = affine(lambda n: rf.st_flops(n, m["dim_input"], m["dim_hidden"], m["num_inds"],
                                        m["num_classes"]))
    flops = a * ctx.host.counts["clouds"] + b * ctx.host.counts["kept_points"]
    if not flops or ctx.host.seconds <= 0:
        return None
    return 100.0 * flops / ctx.host.seconds / rf.PEAK_FLOPS["tf32"]
