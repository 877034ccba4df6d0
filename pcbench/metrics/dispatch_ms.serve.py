"""Host ms to call the temporal classifier (``eval/pipeline.py``) until it
returns, with no sync: what the host spends enqueueing one batch."""
from pcbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx.host.spans.get("dispatch", []))
