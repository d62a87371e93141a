"""Device ms a SLAM step of the registration: the interval of the program's
``slam.register`` span on the device (the ICP voxel downsample, the motion
model, K1, a rescue where one runs, the accept test) less the idle inside
it (`_spans.busy_ms_per_call`), over the traced steps."""

from portbench.metrics._spans import busy_ms_per_call


def read(ctx):
    return busy_ms_per_call(ctx, "slam", "slam.register")
