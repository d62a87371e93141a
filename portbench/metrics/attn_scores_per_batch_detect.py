"""Query-key pairs the area attention scores a detector batch (``B area
heads T^2`` a block): the ``scores`` count of the program's
``detect.attention`` spans, over the traced batches."""

from portbench.metrics._spans import count_per_call


def read(ctx):
    return count_per_call(ctx, "detect", "detect.attention", "scores")
