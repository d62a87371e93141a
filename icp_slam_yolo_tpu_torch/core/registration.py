"""Scan registration: masked point-to-point ICP with correspondence gating.

Counterpart of the JAX package's ``core/registration.py`` for the
``point_to_point`` estimator.  ``backend="auto"`` or ``"fused"`` runs K1
(`ops/pallas/icp_fused`): the CUDA kernel for CUDA tensors, its plain version
for CPU tensors.  The port has one ICP, so ``backend="xla"`` raises.

``inlier_rmse`` follows Open3D: RMS distance over correspondences within the
threshold at the final pose; no inliers, or fewer than ``min_points`` valid
points on either side, gives ``+inf`` and the initial pose.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_slam_yolo_tpu_torch.config import IcpConfig
from icp_slam_yolo_tpu_torch.device import resolve_device
from icp_slam_yolo_tpu_torch.ops import geometry as geo
from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import icp_fused


class RegistrationResult(NamedTuple):
    pose: torch.Tensor       # (3,) map-from-scan transform (x_mm, y_mm, theta)
    rmse: torch.Tensor       # inlier RMSE (mm); +inf if degenerate
    fitness: torch.Tensor    # inliers / valid source points
    n_inliers: torch.Tensor  # int32
    n_iters: torch.Tensor    # int32 iterations before the convergence freeze


def check_supported(cfg: IcpConfig) -> None:
    """Raise for the estimator options this slice does not port yet."""
    if cfg.estimator != "point_to_point":
        raise NotImplementedError(
            f"estimator={cfg.estimator!r}: only point_to_point is ported; point_to_plane "
            "and gicp wait for ROADMAP.md 'Open items' 1, item 2 (GICP rescue and realtime preset)"
        )
    if cfg.huber_delta_mm > 0:
        raise NotImplementedError(
            "huber_delta_mm > 0 waits for ROADMAP.md 'Open items' 1, item 2 "
            "(GICP rescue and realtime preset)"
        )
    if cfg.backend == "xla":
        raise NotImplementedError(
            "IcpConfig.backend='xla': the port has one ICP, K1 (backend 'auto' or 'fused')"
        )
    if cfg.backend not in ("auto", "fused"):
        raise ValueError(f"unknown IcpConfig.backend {cfg.backend!r}")


def icp_masked(src_xy, src_valid, tgt_xy, tgt_valid, init_pose,
               cfg: IcpConfig = IcpConfig()) -> RegistrationResult:
    """Masked fixed-shape ICP aligning ``src`` (sensor frame) onto ``tgt``
    (map frame) from ``init_pose``; ``(N, 2)``/``(N,)``/``(M, 2)``/``(M,)``
    tensors and a ``(3,)`` pose, all on one device."""
    check_supported(cfg)
    init_pose = init_pose.to(torch.float32)
    n_src = src_valid.sum()
    n_tgt = tgt_valid.sum()
    pose, rmse, n_in, n_iters = icp_fused(
        src_xy, src_valid, tgt_xy, tgt_valid, init_pose,
        iters=cfg.max_iterations, threshold_mm=cfg.threshold_mm,
        tolerance=cfg.tolerance, anderson=cfg.anderson,
    )
    degenerate = (n_src < cfg.min_points) | (n_tgt < cfg.min_points) | (n_in == 0)
    rmse = torch.where(degenerate, torch.full_like(rmse, float("inf")), rmse)
    pose = torch.where(degenerate, init_pose, pose)
    fitness = n_in / torch.clamp(n_src, min=1)
    return RegistrationResult(pose=pose, rmse=rmse, fitness=fitness, n_inliers=n_in, n_iters=n_iters)


def _pad_points(points, n: int, device):
    pts = np.asarray(points, dtype=np.float32)[:, :2]
    m = min(len(pts), n)
    out = np.zeros((n, 2), np.float32)
    out[:m] = pts[:m]
    valid = np.zeros(n, bool)
    valid[:m] = True
    return torch.from_numpy(out).to(device), torch.from_numpy(valid).to(device)


def icp(src_points, tgt_points, init_pose=None, cfg: IcpConfig = IcpConfig(),
        pad_to: int = 512, device=None) -> RegistrationResult:
    """Host API: register raw ``(N, 2/3)`` arrays (padded + masked like the
    JAX package's ``icp``).  ``device=None`` means the card."""
    dev = resolve_device(device)
    src = np.asarray(src_points)
    tgt = np.asarray(tgt_points)
    s, sv = _pad_points(src, -(-(min(len(src), pad_to) or 8) // 8) * 8, dev)
    t, tv = _pad_points(tgt, -(-max(pad_to, len(tgt)) // 128) * 128, dev)
    init = (geo.se2_identity(dev) if init_pose is None
            else torch.as_tensor(np.asarray(init_pose, np.float32), device=dev))
    return icp_masked(s, sv, t, tv, init, cfg)


def register(src_points, dst_points, init_pose=None, cfg: IcpConfig = IcpConfig(), device=None):
    """``register(src, dst) -> (R (2, 2), t (2,) mm, rmse)`` as numpy/float."""
    res = icp(src_points, dst_points, init_pose=init_pose, cfg=cfg, device=device)
    r = geo.se2_rotation(res.pose)
    return r.cpu().numpy(), res.pose[:2].cpu().numpy(), float(res.rmse)
