"""The attention products in PyTorch's fused SDPA kernels: their summed
least time, counted on the plain model's shapes (``4 T^2 hd heads area``
bf16 operations a block at the tensor-core peak, or q, k, v and the output
once at the memory rate; `reference.yolo12.attention_work`), over the
device time of the kernels the pattern below matches, in percent.

The pattern takes cuDNN's kernels (``sdpa``; on an H100 with PyTorch 2.11
and CUDA 12.8 the breakdown names one,
``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64_4x1x1_cga1x1x1_kernel0_0``),
and the flash (``flash_fwd``) and memory-efficient (``fmha_cutlass``) ones,
whichever fused backend the program's restriction leaves PyTorch to pick."""

import re

from portbench.trace import time_by_name

SDPA = re.compile(r"flash_fwd|fmha_cutlass|sdpa", re.IGNORECASE)


def read(ctx):
    if ctx.kind != "detect" or not ctx.work.get("attn_least_s") or not ctx.traced:
        return None
    s = time_by_name(ctx.trace, ctx.traced, lambda n: SDPA.search(n) is not None)
    if s <= 0:
        return None
    return ctx.work["attn_least_s"] * ctx.units_per_call * ctx.traced / s * 100.0
