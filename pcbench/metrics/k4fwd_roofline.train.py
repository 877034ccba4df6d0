"""K4's forward in the train step against its least time: QKᵀ and A·V of
the five attends over every frame's 1,025 points at the TF32 peak, or Q,
K, V and O moved once at the HBM rate."""
from pcbench import roofline as rf
from pcbench.metrics import device_s

KERNELS = {"mha_fwd_kernel": "K4 forward", "mha_fwd_short_kernel": "K4 forward, short keys",
           "mha_fwd_merge_kernel": "K4 forward, key-split merge"}


def read(ctx):
    t = device_s(ctx.trace, KERNELS)
    if not t:
        return None
    m = ctx.config["model"]
    n, d, ni = ctx.config["featurize"]["n_fft"] // 2 + 1, m["dim_hidden"], m["num_inds"]
    clouds = ctx.counts["clouds"]
    flops = rf.attention_fwd_flops(clouds * rf.st_attention_pairs(n, ni), d)
    return rf.share_pct(rf.roofline_s(flops, rf.st_attention_bytes(clouds, n, ni, d), "tf32"), t)
