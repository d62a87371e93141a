"""Dynamic-point rejection (counterpart of ``dynamic_points_mask`` in the JAX
package's ``ops/outliers.py``).  The statistical outlier filter waits for the
k-NN slice."""

from __future__ import annotations

import torch

from icp_slam_yolo_tpu_torch.ops.nn import nearest_neighbor


def dynamic_points_mask(
    cur_xy: torch.Tensor,
    cur_valid: torch.Tensor,
    prev_xy: torch.Tensor,
    prev_valid: torch.Tensor,
    distance_threshold_mm: float,
) -> torch.Tensor:
    """Keep a point whose nearest previous-scan point lies closer than the
    threshold; keep everything when the previous scan is empty."""
    dist, _ = nearest_neighbor(cur_xy, prev_xy, prev_valid, cur_valid)
    keep = cur_valid & (dist < distance_threshold_mm)
    return torch.where(prev_valid.any(), keep, cur_valid)
