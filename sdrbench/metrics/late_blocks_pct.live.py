"""late_blocks_pct.live: share of the window's blocks that completed more
than one budget (2048 / 192 kHz, 10.667 ms) after they were due, % (a
block that never completed is late)."""

import math

BUDGET_S = 2048 / 192_000


def read(ctx):
    lat = ctx.window.get("latency_s")
    if not lat:
        return None
    late = sum(math.isnan(x) or x > BUDGET_S for x in lat)
    return 100.0 * late / len(lat)
