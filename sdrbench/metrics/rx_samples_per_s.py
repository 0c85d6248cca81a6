"""rx_samples_per_s: complex 192 kHz input samples through the chain
(channels x 2048 x blocks completed) over the whole window, from the
first dispatch's submission to the last one's completion (closed loop)."""


def read(ctx):
    if ctx.mix["loop"] != "closed":
        return None
    return ctx.channels * 2048 * ctx.blocks / ctx.window["window_s"]
