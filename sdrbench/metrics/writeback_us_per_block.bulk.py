"""writeback_us_per_block.bulk: device µs a block of the chain's stage
`writeback` (`runner.capture`'s clones and state copy-back at the end of
each graph), from the program's stage map of its CUDA graph
(`t41x_torch.utils.tracing`): the traced window's device ops cut into
the graph's replays by the map's op counts. None where the program keeps
no stage map."""

STAGE = "writeback"


def read(ctx):
    try:
        from t41x_torch.utils import tracing
    except ImportError:   # a program without the tracer
        return None
    if ctx.trace is None:
        return None
    r = tracing.attribute(ctx.trace.ops)
    s = r["stages"].get(STAGE)
    if not s:
        return None
    return 1e6 * s / (r["replays"] * int(ctx.mix["blocks_per_dispatch"]))
