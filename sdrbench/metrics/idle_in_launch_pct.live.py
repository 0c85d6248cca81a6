"""idle_in_launch_pct: share of the traced window in which no device op
ran while the host was inside a graph launch, %: the program's launch
spans (`t41x_torch.utils.tracing`, recorded while the profiler is on)
placed on the trace's clock by anchoring each launch to the first device
op of its replay.  None where the program records no launch spans or
they cannot be anchored."""


def read(ctx):
    try:
        from t41x_torch.utils import tracing
    except ImportError:   # a program without the tracer
        return None
    t = ctx.trace
    if t is None:
        return None
    r = tracing.launch_idle(t.ops, t.w0, t.w1)
    return None if r is None else 100.0 * r["idle_in_launch"]
