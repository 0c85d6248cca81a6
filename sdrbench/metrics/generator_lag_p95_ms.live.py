"""generator_lag_p95_ms.live: the 95th percentile of how late the load
generator issued each due block's replay, ms."""

from sdrbench.readers import percentile


def read(ctx):
    if "lag_s" not in ctx.window:
        return None
    p = percentile(ctx.window["lag_s"], 95)
    return None if p is None else p * 1e3
