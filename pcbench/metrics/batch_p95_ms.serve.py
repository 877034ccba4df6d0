"""The 95th percentile, over the batches of the untraced window before the
trace, of the time from a batch's submission to its clip logits on the
host."""
import statistics


def read(ctx):
    lat = ctx.host.spans.get("batch_latency", [])
    if len(lat) < 20:
        return None
    return 1e3 * statistics.quantiles(lat, n=20)[18]
