"""Suppression rounds a detector batch: the ``rounds`` count of the
program's ``detect.nms`` span (`ops/nms.suppress`), over the traced
batches."""

from portbench.metrics._spans import count_per_call


def read(ctx):
    return count_per_call(ctx, "detect", "detect.nms", "rounds")
