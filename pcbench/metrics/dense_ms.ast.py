"""Device ms a batch of the AST's encoder outside its attention: the
kernels inside ``pipeline.encoder``'s device ranges less those inside
``pipeline.attn``'s (K5), i.e. the QKV, out-projection and MLP GEMMs,
LayerNorm, GELU and the residual adds (``nn/ast.py``)."""
from pcbench.spans import device_ranges, device_s_within


def read(ctx):
    enc = device_ranges(ctx.trace, ("pipeline.encoder",))
    att = device_ranges(ctx.trace, ("pipeline.attn",))
    if not enc or not att or not ctx.counts["batches"]:
        return None
    dense = device_s_within(ctx.trace, enc) - device_s_within(ctx.trace, att)
    return 1e3 * dense / ctx.counts["batches"]
