"""Host ms from calling the SLAM step to its return, mean over the steps of
the window outside the profiler's slice (the fleet API and the step's
Python: every launch is issued inside it)."""


def read(ctx):
    if ctx.kind != "slam" or not ctx.dispatch_s:
        return None
    return sum(ctx.dispatch_s) / len(ctx.dispatch_s) * 1e3
