"""K5-K7: convolution + bias + SiLU in one kernel, NHWC, bf16 or f32.

Counterparts of the JAX package's ``conv1x1_silu``, ``conv3x3_silu`` and
``conv3x3s2_silu`` (``ops/pallas/conv_fused.py``).  The CUDA kernel is
``csrc/conv.cu``; its source says what bounds it and how it is laid out.
The JAX kernels' pixel-group packing and banded weights are layout
workarounds of their target and are not carried over, and neither are their
shape conditions: every shape is taken, except an odd height or width at
stride 2, which raises as it does there.

Rounding, as in the JAX kernels: inputs, weights and the bias are in the
working type (the bias is rounded to it before the call and widened again in
the kernel), the sum and the SiLU are float32, the result is rounded once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.pallas import _lib

_TYPES = (torch.bfloat16, torch.float32)


def use_kernels(batch: int, h: int) -> bool:
    """The regime gate of the fused path (`_use_pallas` in the JAX package).
    It answers yes for every batch and height: the JAX package's cut-offs
    were measured on its own target and are not copied; cut-offs for this
    card are to be set from fused against unfused times measured on it."""
    return True


def conv_bias_act_plain(x, w, b, stride: int = 1, act: bool = True):
    """Plain version of K5-K7: ``x (B, H, W, Cin)``, ``w (k, k, Cin, Cout)``
    HWIO, ``b (Cout,)`` -> ``(B, Ho, Wo, Cout)`` in ``x.dtype``; padding
    ``k // 2``, float32 sum and SiLU, one rounding at the end."""
    k = w.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.permute(3, 2, 0, 1).float(), b.float(),
                 stride=stride, padding=k // 2)
    if act:
        y = F.silu(y)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def _conv(name: str, x, w, b, stride: int, act: bool):
    dev, dt = x.device, x.dtype
    if dt not in _TYPES:
        raise TypeError(f"{name}: dtype {dt}, expected bfloat16 or float32")
    bsz, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    pallas.check_tensor(x, "x", dt, (bsz, h, wd, cin), dev)
    pallas.check_tensor(w, "w", dt, (k, k, cin, cout), dev)
    pallas.check_tensor(b, "b", dt, (cout,), dev)
    if stride == 2 and (h % 2 or wd % 2):
        raise ValueError(f"{name}: stride 2 needs even H and W, got {h} x {wd}")
    if dev.type == "cpu":
        return conv_bias_act_plain(x, w, b, stride, act)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    out = torch.empty((bsz, h // stride, wd // stride, cout), dtype=dt, device=dev)
    err = _lib.lib().slam_conv_bias_act(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, h, wd, cin, cout,
        k, stride, int(act), int(dt == torch.bfloat16), _lib.stream_ptr(dev),
    )
    _lib.check(err, name)
    pallas.LAUNCHES[name] += 1
    return out


def conv1x1_silu(x, w, b, act: bool = True):
    """K5: ``silu(x @ w + b)`` over the channel axis (``act=False``: no
    SiLU).  ``x (B, H, W, Cin)``, ``w (Cin, Cout)``, ``b (Cout,)``, all of one
    type.  Launches the CUDA kernel for CUDA tensors; the plain version runs
    only for CPU tensors."""
    if w.dim() != 2:
        raise ValueError(f"conv1x1_silu: w has shape {tuple(w.shape)}, expected (Cin, Cout)")
    return _conv("conv1x1_silu", x, w[None, None], b, 1, act)


def conv3x3_silu(x, w, b):
    """K6: ``silu(conv3x3(x, w) + b)``, stride 1, SAME zero padding;
    ``w (3, 3, Cin, Cout)`` HWIO."""
    if w.dim() != 4 or w.shape[0] != 3 or w.shape[1] != 3:
        raise ValueError(f"conv3x3_silu: w has shape {tuple(w.shape)}, expected (3, 3, Cin, Cout)")
    return _conv("conv3x3_silu", x, w, b, 1, True)


def conv3x3s2_silu(x, w, b):
    """K7: the same at stride 2 with padding 1 on even H and W: the window of
    output ``(i, j)`` covers input rows ``2i-1..2i+1`` (one zero row above the
    image, none below); out ``(B, H/2, W/2, Cout)``."""
    if w.dim() != 4 or w.shape[0] != 3 or w.shape[1] != 3:
        raise ValueError(f"conv3x3s2_silu: w has shape {tuple(w.shape)}, expected (3, 3, Cin, Cout)")
    return _conv("conv3x3s2_silu", x, w, b, 2, True)
