"""The fused conv kernels (K5-K7 ``conv_*_kernel``, K8 ``c2f_*_kernel``):
the summed least time of the conv sites, counted on the plain model's
shapes (bf16 operations at the tensor-core peak, or input, weights and
output each once at the memory rate; a C2f with one bottleneck as one
block), over the kernels' summed device time, in percent."""

import re

from portbench.trace import time_by_name

_FUSED = re.compile(r"(conv_(bf16|f32|wgmma)|c2f_(bf16|f32))_kernel")


def read(ctx):
    if ctx.kind != "detect" or not ctx.work.get("conv_least_s") or not ctx.traced:
        return None
    s = time_by_name(ctx.trace, ctx.traced, lambda n: _FUSED.search(n) is not None)
    if s <= 0:
        return None
    return ctx.work["conv_least_s"] * ctx.units_per_call * ctx.traced / s * 100.0
