"""K4's forward on the sweep's masked forwards against its least time: QKᵀ
and A·V over the kept points of each attend at the TF32 peak, or Q, K, V
and O moved once at the HBM rate."""
from pcbench import roofline as rf
from pcbench.metrics import affine, device_s

KERNELS = {"mha_fwd_kernel": "K4 forward", "mha_fwd_short_kernel": "K4 forward, short keys",
           "mha_fwd_merge_kernel": "K4 forward, key-split merge"}


def read(ctx):
    t = device_s(ctx.trace, KERNELS)
    if not t:
        return None
    m = ctx.config["model"]
    d, ni = m["dim_hidden"], m["num_inds"]
    clouds, kept = ctx.counts["clouds"], ctx.counts["kept_points"]
    pa, pb = affine(lambda n: rf.st_attention_pairs(n, ni))
    ba, bb = affine(lambda n: rf.st_attention_bytes(1, n, ni, d))
    flops = rf.attention_fwd_flops(pa * clouds + pb * kept, d)
    return rf.share_pct(rf.roofline_s(flops, ba * clouds + bb * kept, "tf32"), t)
