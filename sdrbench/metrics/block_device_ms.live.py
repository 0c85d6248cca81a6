"""block_device_ms.live: all device time in the traced window over the
blocks processed in it, ms."""

from sdrbench.readers import device_s_per_block


def read(ctx):
    s = device_s_per_block(ctx)
    return None if s is None else s * 1e3
