"""Three times the ST forward's FLOPs on every frame cloud trained on in
the untraced window before the trace, over its seconds, as a share of
the TF32 peak."""
from pcbench import roofline as rf


def read(ctx):
    m = ctx.config["model"]
    n = ctx.config["featurize"]["n_fft"] // 2 + 1
    flops = 3 * ctx.host.counts["clouds"] * rf.st_flops(n, m["dim_input"], m["dim_hidden"],
                                                   m["num_inds"], m["num_classes"])
    if not flops or ctx.host.seconds <= 0:
        return None
    return 100.0 * flops / ctx.host.seconds / rf.PEAK_FLOPS["tf32"]
