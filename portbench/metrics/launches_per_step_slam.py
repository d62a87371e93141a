"""Device operations (kernels, copies, fills) a SLAM step in the profiler's
window."""


def read(ctx):
    if ctx.kind != "slam" or not ctx.traced:
        return None
    return len(ctx.trace.kernels) / ctx.traced
