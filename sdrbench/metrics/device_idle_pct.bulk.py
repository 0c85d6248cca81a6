"""device_idle_pct: share of the traced window in which no kernel, copy
or set ran on the card (profiler), %."""

from sdrbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
