"""K3: nearest valid target per source point, ``(min d², argmin)``.

Counterpart of the JAX package's ``nn_argmin_pallas``
(``ops/pallas/nn_kernel.py``).  The CUDA kernel is ``csrc/nn.cu``; its source
says what bounds it and how it is laid out.
"""

from __future__ import annotations

import torch

from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.pallas import _lib

_BIG = 1e30


def nn_argmin_plain(src_xy: torch.Tensor, tgt_xy: torch.Tensor, tgt_valid: torch.Tensor):
    """Plain version: difference-form d², invalid targets excluded, first
    index on ties; ``(1e30, 0)`` when no target is valid."""
    dx = src_xy[:, None, 0] - tgt_xy[None, :, 0]
    dy = src_xy[:, None, 1] - tgt_xy[None, :, 1]
    d2 = dx * dx + dy * dy
    d2 = torch.where(tgt_valid[None, :], d2, torch.full_like(d2, _BIG))
    idx = torch.argmin(d2, dim=1)  # first occurrence of the minimum
    return torch.gather(d2, 1, idx[:, None])[:, 0], idx.to(torch.int32)


def nn_argmin(src_xy: torch.Tensor, tgt_xy: torch.Tensor, tgt_valid: torch.Tensor):
    """``(S, 2) f32, (T, 2) f32, (T,) bool -> ((S,) f32 d², (S,) int32)``.

    Launches the CUDA kernel for CUDA tensors; the plain version runs only
    for CPU tensors.
    """
    dev = src_xy.device
    s, t = src_xy.shape[0], tgt_xy.shape[0]
    pallas.check_tensor(src_xy, "src_xy", torch.float32, (s, 2), dev)
    pallas.check_tensor(tgt_xy, "tgt_xy", torch.float32, (t, 2), dev)
    pallas.check_tensor(tgt_valid, "tgt_valid", torch.bool, (t,), dev)
    if dev.type == "cpu":
        return nn_argmin_plain(src_xy, tgt_xy, tgt_valid)
    if dev.type != "cuda":
        raise ValueError(f"nn_argmin: unsupported device {dev}")
    d2 = torch.empty(s, dtype=torch.float32, device=dev)
    idx = torch.empty(s, dtype=torch.int32, device=dev)
    lib = _lib.lib()
    err = lib.slam_nn_argmin(
        src_xy.data_ptr(), tgt_xy.data_ptr(), tgt_valid.data_ptr(), s, t,
        d2.data_ptr(), idx.data_ptr(), _lib.stream_ptr(dev),
    )
    _lib.check(err, "nn_argmin")
    pallas.LAUNCHES["nn_argmin"] += 1
    return d2, idx
