"""K1 (the whole ST forward) against its least time: the ST's FLOPs on each
valid chunk cloud at the bf16 peak, or the clouds read (bf16) and the
logits written (f32) at the HBM rate."""
from pcbench import roofline as rf
from pcbench.metrics import device_s

KERNELS = {"fused_st_kernel": "K1", "fused_st_scratch_kernel": "K1, scratch form"}


def read(ctx):
    t = device_s(ctx.trace, KERNELS)
    if not t:
        return None
    m, k = ctx.config["model"], ctx.config["pipeline"]["top_k"]
    n = ctx.counts["valid_clouds"]
    flops = n * rf.st_flops(k, m["dim_input"], m["dim_hidden"], m["num_inds"], m["num_classes"])
    nbytes = n * (k * m["dim_input"] * 2 + m["num_classes"] * 4)
    return rf.share_pct(rf.roofline_s(flops, nbytes, "bf16"), t)
