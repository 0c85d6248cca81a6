"""program_setup_s: the set-up the program itself times, s: the spans
`kernel_load` (the kernel library's build or load), `design`
(`RxChain.__init__`) and `capture` (`runner.capture`, warm-up run and
capture) of `t41x_torch.utils.tracing`, each less the spans nested in
it.  None where the program records no set-up span."""

SPANS = ("kernel_load", "design", "capture")


def read(ctx):
    try:
        from t41x_torch.utils import tracing
    except ImportError:   # a program without the tracer
        return None
    s = tracing.setup_seconds()
    total = sum(s.get(k, 0.0) for k in SPANS)
    return total if total > 0 else None
