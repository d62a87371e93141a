"""Hand-written CUDA kernels for Hopper, at the paths of the JAX package's
Pallas kernels they replace (``ops/pallas/*.py`` there), and K9
(`knn_kernel`), which replaces none.

Each module holds a wrapper and a plain PyTorch version of the same
function.  The wrapper launches the kernel (``csrc/*.cu``, built by `_lib` at
first use) for a CUDA tensor and runs the plain version only for a CPU
tensor; there is no fallback from a failed launch.  Each wrapper counts its
launches in a plain integer (``LAUNCHES[name]``), so a run can show that the
main path went through the kernel.  Each module's `layouts` lists the launch
layouts that fit a shape, its planner picks one, and the wrapper takes any
of them as ``plan=``: every layout gives the same bits.
"""

from __future__ import annotations

import torch

LAUNCHES = {
    "icp_fused": 0, "raster_update": 0, "nn_argmin": 0, "raster_update_grid": 0,
    "conv1x1_silu": 0, "conv3x3_silu": 0, "conv3x3s2_silu": 0, "c2f_fused": 0, "knn_outlier": 0,
    "conv_tma": 0,  # of the three above, the launches that took the TMA-fed warpgroup loop
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def chosen(name: str, plan, planner, layouts, *shape, **kw):
    """``planner``'s layout for a shape, or ``plan``, which must be one of
    ``layouts`` of the shape (``ValueError`` otherwise)."""
    if plan is None:
        return planner(*shape, **kw)
    if plan not in layouts(*shape, **kw):
        raise ValueError(f"{name}: {plan} is no layout of this shape")
    return plan


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device: torch.device):
    """Raise unless ``t`` has this dtype, shape (``None`` = any size), device
    and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if len(t.shape) != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
