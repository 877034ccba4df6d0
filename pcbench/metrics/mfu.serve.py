"""The ST's FLOPs on the valid chunk clouds classified in the untraced
window before the trace, over its seconds, as a share of the bf16 peak
(the STFT left out)."""
from pcbench import roofline as rf


def read(ctx):
    m, k = ctx.config["model"], ctx.config["pipeline"]["top_k"]
    flops = ctx.host.counts["valid_clouds"] * rf.st_flops(
        k, m["dim_input"], m["dim_hidden"], m["num_inds"], m["num_classes"])
    if not flops or ctx.host.seconds <= 0:
        return None
    return 100.0 * flops / ctx.host.seconds / rf.PEAK_FLOPS["bf16"]
