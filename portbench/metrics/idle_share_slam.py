"""The share (%) of the profiler's window in which no operation ran on the
device, in a SLAM cell."""


def read(ctx):
    if ctx.kind != "slam":
        return None
    return (1.0 - ctx.trace.busy_us / ctx.trace.window_us) * 100.0
