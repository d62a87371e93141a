"""Device ms a detector batch of the area attention: the intervals of the
program's ``detect.attention`` spans on the device (each from its own
entry: band split, the fused products, band merge) less the idle inside
them (`_spans.busy_ms_per_call`), over the traced batches; nothing where
the program keeps no such span."""

from portbench.metrics._spans import busy_ms_per_call


def read(ctx):
    return busy_ms_per_call(ctx, "detect", "detect.attention")
