"""Device ms a SLAM step of the map kernels: the occupancy update (K4,
``raster_kernel``) and the nearest-neighbour kernel of the dynamic-points
filter (K3, ``nn_argmin_kernel``)."""

from portbench.trace import time_by_name


def read(ctx):
    if ctx.kind != "slam" or not ctx.traced:
        return None
    s = time_by_name(ctx.trace, ctx.traced, lambda n: "raster_kernel" in n or "nn_argmin_kernel" in n)
    return s * 1e3 / ctx.traced if s > 0 else None
