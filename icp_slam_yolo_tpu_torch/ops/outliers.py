"""Point-cloud hygiene filters: statistical outliers and dynamic points
(counterpart of the JAX package's ``ops/outliers.py``).  The statistical
filter goes through K9 and takes leading batch axes (clouds ``(..., N, 2)``,
masks ``(..., N)``); the dynamic filter goes through K3 and takes ``(B, N,
2)``."""

from __future__ import annotations

import torch

from icp_slam_yolo_tpu_torch.ops.nn import nearest_neighbor
from icp_slam_yolo_tpu_torch.ops.pallas.knn_kernel import knn_outlier


def statistical_outlier_mask(xy: torch.Tensor, valid: torch.Tensor, nb_neighbors: int = 30,
                             std_ratio: float = 1.5) -> torch.Tensor:
    """Keep-mask per Open3D semantics: drop points whose mean k-NN distance
    exceeds ``mean + std_ratio * std`` of that statistic over the cloud: one
    K9 launch for all the clouds."""
    n = valid.shape[-1]
    flat_xy, flat_valid = xy.reshape(-1, n, 2).contiguous(), valid.reshape(-1, n).contiguous()
    _, keep = knn_outlier(flat_xy, flat_valid, nb_neighbors, std_ratio)
    return keep.reshape(valid.shape)


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
    return torch.where(prev_valid.any(-1, keepdim=True), keep, cur_valid)
