"""K5 (``csrc/attn.cu``, the AST's attention) against its least time: QKᵀ
and P·V of every clip, layer and head at the bf16 peak, or Q, K, V read and
O written once (bf16) at the HBM rate.  At the published sizes the
products bound it; the exps (N² a head, 16 a clock per SM) would take
about the same 7.0 ms a 128-clip batch, but no exp rate is a published
peak."""
from pcbench import ast_roofline as ar
from pcbench import roofline as rf
from pcbench.metrics import device_s

KERNELS = {"attn_fwd_kernel": "K5"}


def read(ctx):
    t = device_s(ctx.trace, KERNELS)
    if not t:
        return None
    m = ctx.config["model"]
    n, clips = ar.tokens(m), ctx.counts["clips"]
    return rf.share_pct(rf.roofline_s(clips * ar.k5_flops(m, n), clips * ar.k5_bytes(m, n),
                                      "bf16"), t)
