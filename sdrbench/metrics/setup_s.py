"""setup_s: seconds from process start to the first measured dispatch
(kernel load or build, filter design, inputs, graph capture, warm-up)."""


def read(ctx):
    return ctx.setup_s
