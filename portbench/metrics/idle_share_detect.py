"""The share (%) of the profiler's window in which no operation ran on the
device, in a detector cell."""


def read(ctx):
    if ctx.kind != "detect":
        return None
    return (1.0 - ctx.trace.busy_us / ctx.trace.window_us) * 100.0
