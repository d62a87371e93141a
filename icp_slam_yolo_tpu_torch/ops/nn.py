"""Masked brute-force nearest neighbour.

Counterpart of ``nearest_neighbor`` in the JAX package's ``ops/nn.py``.  The
port always goes through K3 (`ops/pallas/nn_kernel.nn_argmin`): the CUDA
kernel on the card, its plain version on the CPU.  k-NN and the local
covariances belong to a later slice (the GICP rescue).
"""

from __future__ import annotations

import torch

from icp_slam_yolo_tpu_torch.ops.pallas.nn_kernel import nn_argmin

_BIG = 1e30


def nearest_neighbor(
    src_xy: torch.Tensor,
    tgt_xy: torch.Tensor,
    tgt_valid: torch.Tensor,
    src_valid: torch.Tensor | None = None,
):
    """Nearest valid target for every source point.

    Returns ``(dist_mm (N,) f32, idx (N,) int32)``; invalid sources get
    distance ``1e30``.
    """
    d2, idx = nn_argmin(src_xy, tgt_xy, tgt_valid)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    if src_valid is not None:
        dist = torch.where(src_valid, dist, torch.full_like(dist, _BIG))
    return dist, idx
