"""The AST's FLOPs on the clips classified in the untraced window before the
trace, over its seconds, as a share of the bf16 peak: a clip's FLOPs at
the tokens the program counted (``pipeline.tokens`` over the traced
window's clips; 261.1 GFLOP a clip at 1,214 tokens), the fbank left out."""
from pcbench import ast_roofline as ar
from pcbench import roofline as rf
from pcbench.spans import counters

TOKENS = "pipeline.tokens"


def read(ctx):
    c = counters((TOKENS,))
    if c is None or not ctx.counts["clips"] or ctx.host.seconds <= 0:
        return None
    n = c[TOKENS] // ctx.counts["clips"]
    flops = ctx.host.counts["clips"] * ar.ast_flops(ctx.config["model"], n)
    return 100.0 * flops / ctx.host.seconds / rf.PEAK_FLOPS["bf16"]
