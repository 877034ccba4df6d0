"""K1 on the full grid (``top_k`` null: every bin of each chunk, the
scratch form) against its least time: the ST's FLOPs on each valid chunk
cloud of ``num_frames · n_fft / 2`` points at the bf16 peak, or the clouds
read (bf16) and the logits written (f32) at the HBM rate.  The count is
``st_roofline.serve``'s at the full grid's points."""
from pcbench import roofline as rf
from pcbench.metrics import device_s

KERNELS = {"fused_st_kernel": "K1", "fused_st_scratch_kernel": "K1, scratch form"}


def read(ctx):
    t = device_s(ctx.trace, KERNELS)
    if not t:
        return None
    m, p = ctx.config["model"], ctx.config["pipeline"]
    k = p["num_frames"] * (p["n_fft"] // 2)
    n = ctx.counts["valid_clouds"]
    flops = n * rf.st_flops(k, m["dim_input"], m["dim_hidden"], m["num_inds"], m["num_classes"])
    nbytes = n * (k * m["dim_input"] * 2 + m["num_classes"] * 4)
    return rf.share_pct(rf.roofline_s(flops, nbytes, "bf16"), t)
