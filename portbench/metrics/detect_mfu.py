"""The whole detector step's share (%) of the card's bfloat16 peak: the
forward's operations an image, counted on the plain model's conv shapes,
times the frames a second of the window, over 989 TFLOP/s."""

from portbench.spec import PEAK_BF16


def read(ctx):
    if ctx.kind != "detect" or not ctx.work.get("forward_ops") or not ctx.rate:
        return None
    return ctx.work["forward_ops"] * ctx.rate / PEAK_BF16 * 100.0
