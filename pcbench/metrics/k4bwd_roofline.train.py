"""K4's backward in the train step against its least time: 2.5 times the
forward's products at the TF32 peak, or Q, K, V, O, dO, the row
log-sum-exps, dQ, dK and dV moved once at the HBM rate."""
from pcbench import roofline as rf
from pcbench.metrics import device_s

KERNELS = {"mha_bwd_fewq_kernel": "K4 backward, few queries",
           "mha_bwd_fewk_kernel": "K4 backward, few keys",
           "mha_bwd_merge_kernel": "K4 backward, split merge",
           "mha_dq_kernel": "K4 backward pair, dQ", "mha_dkdv_kernel": "K4 backward pair, dK dV"}


def read(ctx):
    t = device_s(ctx.trace, KERNELS)
    if not t:
        return None
    m = ctx.config["model"]
    n, d, ni = ctx.config["featurize"]["n_fft"] // 2 + 1, m["dim_hidden"], m["num_inds"]
    clouds = ctx.counts["clouds"]
    flops = rf.attention_bwd_flops(clouds * rf.st_attention_pairs(n, ni), d)
    nbytes = rf.st_attention_bytes(clouds, n, ni, d, backward=True)
    return rf.share_pct(rf.roofline_s(flops, nbytes, "tf32"), t)
