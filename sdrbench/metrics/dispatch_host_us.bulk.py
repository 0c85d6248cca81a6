"""dispatch_host_us.bulk: host µs to launch one graph replay (the
harness's span around `replay()`), mean over the traced window."""


def read(ctx):
    spans = ctx.window["spans"]
    return 1e6 * sum(spans) / len(spans) if spans else None
