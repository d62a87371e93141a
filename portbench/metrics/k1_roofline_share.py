"""K1 (``icp_kernel``): the least time of its counted work over its device
time, in percent.  The work is the benchmark's own count from the step's
inputs (`portbench.entries._slam.SlamSession.layer_work`): 2 float32
operations a (source, target) pair a sweep at the float32 rate, against
the points' bytes at the memory rate."""

from portbench.spec import PEAK_BYTES, PEAK_FP32
from portbench.trace import time_by_name


def read(ctx):
    if ctx.kind != "slam" or not ctx.work.get("k1_ops"):
        return None
    k1_s = time_by_name(ctx.trace, ctx.traced, lambda n: "icp_kernel" in n)
    if k1_s <= 0:
        return None
    least = max(ctx.work["k1_ops"] / PEAK_FP32, ctx.work["k1_bytes"] / PEAK_BYTES)
    return least / k1_s * 100.0
