"""Arithmetic the metric readers share (`metrics/*.py`)."""

from __future__ import annotations

import math


def percentile(values, q: float):
    """The q-th percentile, linear between order statistics (numpy's
    default); a missing value (NaN) counts as infinitely late."""
    xs = sorted(math.inf if math.isnan(v) else v for v in values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]):
        return None
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def idle_pct(ctx):
    """Share of the traced window with no operation on the card, %."""
    t = ctx.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def device_s_per_block(ctx, names=None):
    """Device seconds a block of the operations whose names hold one of
    `names` (all operations when None); None when nothing matched."""
    t = ctx.trace
    if t is None or not ctx.blocks:
        return None
    s = t.device_s(names)
    return s / ctx.blocks if s > 0 else None


def roofline_pct(ctx, names, work):
    """A kernel's share of its roofline in the chain, %: the bound of
    `work` = (operations, bytes) a block, over the kernel's device time a
    block."""
    from sdrbench.roofline import bound_s
    s = device_s_per_block(ctx, names)
    return None if s is None else 100.0 * bound_s(*work) / s
