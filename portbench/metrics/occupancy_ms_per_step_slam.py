"""Device ms a SLAM step of the occupancy update: the interval of the
program's ``slam.occupancy`` span on the device (K4 in the fleet; in the
shared step the robots' grid copies, K4 and the log-space merge) less the
idle inside it (`_spans.busy_ms_per_call`), over the traced steps."""

from portbench.metrics._spans import busy_ms_per_call


def read(ctx):
    return busy_ms_per_call(ctx, "slam", "slam.occupancy")
