"""bandpass_us_per_block.bulk: device µs a block of the chain's stage
`bandpass` (the SSB level scaling and the overlap-save band-pass, with
the audio-spectrum tap where it is fused in: the spectrum-tap GEMMs and
`|X|^2 mask_sq`, or K4), from the program's stage map of its CUDA graph
(`t41x_torch.utils.tracing`): the traced window's device ops cut into
the graph's replays by the map's op counts. None where the program keeps
no stage map."""

STAGE = "bandpass"


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
