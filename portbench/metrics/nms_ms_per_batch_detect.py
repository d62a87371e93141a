"""Device ms a detector batch of the non-maximum suppression: the interval
of the program's ``detect.nms`` span on the device (the IoU matrix, the
suppression rounds) less the idle inside it, the waits its host reads
leave among them (`_spans.busy_ms_per_call`), over the traced batches."""

from portbench.metrics._spans import busy_ms_per_call


def read(ctx):
    return busy_ms_per_call(ctx, "detect", "detect.nms")
