"""chain_us_per_block.bulk: all device time in the traced window over the
blocks processed in it, µs (the receive chain's device cost a block)."""

from sdrbench.readers import device_s_per_block


def read(ctx):
    s = device_s_per_block(ctx)
    return None if s is None else s * 1e6
