"""block_latency_p95_ms: the 95th percentile, over every block due in
the window (the late ones drained and counted), of the time from the
block's due time to the host seeing its outputs complete (open loop)."""

from sdrbench.readers import percentile


def read(ctx):
    if ctx.mix["loop"] != "open":
        return None
    p = percentile(ctx.window["latency_s"], 95)
    return None if p is None else p * 1e3
