"""Scan registration: masked ICP with correspondence gating.

Counterpart of the JAX package's ``core/registration.py``.  The
``point_to_point`` estimator without Huber weights always runs K1
(`ops/pallas/icp_fused`): the CUDA kernel for CUDA tensors, its plain version
for CPU tensors; the port has no second point-to-point ICP, so
``backend="xla"`` raises for it.  ``point_to_plane`` (one-NN tangent
normals), ``gicp`` (k-NN covariances, Mahalanobis Gauss-Newton step with a
closed-form 3 x 3 solve) and Huber weights run the general loop below, plain
PyTorch as it is plain XLA in the JAX package, with its nearest neighbour
through K3.  All iterations run, with a convergence freeze: no host read per
iteration.

Every masked function takes ``B`` registrations with a leading axis; the host
API (`icp`, `register`, `gicp`) lifts its one registration to ``B = 1``.

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
from icp_slam_yolo_tpu_torch.ops.kabsch import best_fit_se2
from icp_slam_yolo_tpu_torch.ops.nn import (
    local_covariances,
    local_covariances_at,
    nearest_neighbor,
    pairwise_sqdist,
)
from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import icp_fused
from icp_slam_yolo_tpu_torch.ops.voxel import voxel_downsample

_ESTIMATORS = ("point_to_point", "point_to_plane", "gicp")


class RegistrationResult(NamedTuple):
    pose: torch.Tensor       # (..., 3) map-from-scan transform (x_mm, y_mm, theta)
    rmse: torch.Tensor       # inlier RMSE (mm); +inf if degenerate
    fitness: torch.Tensor    # inliers / valid source points
    n_inliers: torch.Tensor  # int32
    n_iters: torch.Tensor    # int32 iterations before the convergence freeze


def _uses_k1(cfg: IcpConfig) -> bool:
    return cfg.estimator == "point_to_point" and cfg.huber_delta_mm == 0


def check_supported(cfg: IcpConfig) -> None:
    """Raise for an unknown estimator or backend, and for ``backend="xla"``
    with the estimator that K1 covers."""
    if cfg.estimator not in _ESTIMATORS:
        raise ValueError(f"unknown IcpConfig.estimator {cfg.estimator!r}")
    if cfg.backend not in ("auto", "fused", "xla"):
        raise ValueError(f"unknown IcpConfig.backend {cfg.backend!r}")
    if _uses_k1(cfg) and cfg.backend == "xla":
        raise NotImplementedError(
            "IcpConfig.backend='xla' with point_to_point: the port has one such ICP, K1 "
            "(backend 'auto' or 'fused')"
        )
    if not _uses_k1(cfg) and cfg.backend == "fused":
        raise ValueError(f"backend='fused' covers point_to_point without Huber weights, not {cfg.estimator!r}")


def _target_normals(tgt_xy: torch.Tensor, tgt_valid: torch.Tensor) -> torch.Tensor:
    """2-D normals per target point from its nearest valid neighbour: the
    tangent is the direction to the closest other point, the normal its
    perpendicular."""
    p = (tgt_xy - geo.masked_mean(tgt_xy, tgt_valid)[..., None, :]) * 1e-3
    d2 = pairwise_sqdist(p, p)
    eye = torch.eye(tgt_xy.shape[-2], dtype=torch.bool, device=tgt_xy.device)
    nn_idx = torch.argmin(d2.masked_fill(eye | ~tgt_valid[..., None, :], 1e30), dim=-1)
    tangent = _rows(tgt_xy, nn_idx) - tgt_xy
    tangent = tangent / torch.clamp(torch.sqrt((tangent * tangent).sum(-1, keepdim=True)), min=1e-6)
    return torch.stack([-tangent[..., 1], tangent[..., 0]], dim=-1)


def _rows(xy: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``xy (B, M, 2)`` at ``idx (B, N)`` -> ``(B, N, 2)``."""
    return torch.gather(xy, 1, idx.long()[..., None].expand(*idx.shape, 2))


def _gicp_step(pose, moved, matched, w, cov_src, tgt_xy, tgt_valid, cfg: IcpConfig):
    """One Gauss-Newton step of the GICP objective ``sum_i w_i r_i^T (C_tgt_i +
    R C_src_i R^T)^-1 r_i`` over SE(2), solved in metres so the 3 x 3 normal
    matrix stays conditioned in f32; the symmetric solve is closed form."""
    rot = geo.se2_rotation(pose)[:, None]  # (B, 1, 2, 2)
    ca = rot @ cov_src @ rot.transpose(-1, -2)
    s = local_covariances_at(matched, tgt_xy, tgt_valid, cfg.gicp_k, cfg.gicp_epsilon) + ca
    det = torch.clamp(s[..., 0, 0] * s[..., 1, 1] - s[..., 0, 1] * s[..., 1, 0], min=1e-12)
    m00, m01, m11 = s[..., 1, 1] / det, -s[..., 0, 1] / det, s[..., 0, 0] / det
    pm = moved * 1e-3
    r = pm - matched * 1e-3
    jx, jy = -pm[..., 1], pm[..., 0]  # d(residual)/d(theta) = perp(p)
    u0 = m00 * r[..., 0] + m01 * r[..., 1]
    u1 = m01 * r[..., 0] + m11 * r[..., 1]
    t0 = m00 * jx + m01 * jy
    t1 = m01 * jx + m11 * jy

    def ws(v):
        return (w * v).sum(-1)

    a00, a01, a02 = ws(m00) + 1e-9, ws(m01), ws(t0)
    a11, a12 = ws(m11) + 1e-9, ws(t1)
    a22 = ws(jx * t0 + jy * t1) + 1e-9
    g0, g1, g2 = ws(u0), ws(u1), ws(jx * u0 + jy * u1)
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = torch.where(det.abs() > 1e-30, 1.0 / det, torch.zeros_like(det))
    delta = torch.stack([
        -(c00 * g0 + c01 * g1 + c02 * g2) * inv_det,
        -(c01 * g0 + c11 * g1 + c12 * g2) * inv_det,
        -(c02 * g0 + c12 * g1 + c22 * g2) * inv_det,
    ], dim=-1)
    delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
    return torch.cat([delta[:, :2] * 1e3, delta[:, 2:]], dim=-1)  # metres -> mm


def _general_loop(src_xy, src_valid, tgt_xy, tgt_valid, init_pose, cfg: IcpConfig):
    """The iteration of the estimators K1 does not cover, on ``B``
    registrations: ``(pose, rmse, n_inliers, n_iters)`` before the degenerate
    rule."""
    use_p2l = cfg.estimator == "point_to_plane"
    use_gicp = cfg.estimator == "gicp"
    normals = _target_normals(tgt_xy, tgt_valid) if use_p2l else None
    cov_src = local_covariances(src_xy, src_valid, cfg.gicp_k, cfg.gicp_epsilon) if use_gicp else None

    pose = init_pose
    prev_err = torch.full_like(init_pose[:, 0], 1e30)
    done = torch.zeros_like(prev_err, dtype=torch.bool)
    iters = torch.zeros_like(prev_err, dtype=torch.int32)
    prev_f, prev_g, have_prev = torch.zeros_like(init_pose), init_pose, False
    for _ in range(cfg.max_iterations):
        moved = geo.se2_apply(pose, src_xy)
        dist, idx = nearest_neighbor(moved, tgt_xy, tgt_valid, src_valid)
        matched = _rows(tgt_xy, idx)
        inl = src_valid & (dist < cfg.threshold_mm)
        w = inl.to(torch.float32)
        if cfg.huber_delta_mm > 0:
            w = w * torch.clamp(cfg.huber_delta_mm / torch.clamp(dist, min=1e-6), max=1.0)
        if use_gicp:
            delta = _gicp_step(pose, moved, matched, w, cov_src, tgt_xy, tgt_valid, cfg)
        else:
            if use_p2l:
                # project the residual onto the target normal: point-to-point
                # against the foot of the perpendicular
                nrm = _rows(normals, idx)
                matched = moved + ((matched - moved) * nrm).sum(-1, keepdim=True) * nrm
            dtheta, dt = best_fit_se2(moved, matched, w)
            delta = torch.cat([dt, dtheta[:, None]], dim=-1)
        new_pose = geo.se2_compose(delta, pose)
        if cfg.anderson:
            # Anderson(1) on the pose fixed point: extrapolate through the
            # last two plain iterates; rotation in millimetre-like units
            f = new_pose - pose
            f = torch.cat([f[:, :2], f[:, 2:] * 1000.0], dim=-1)
            df = f - prev_f
            den = (df * df).sum(-1)
            gamma = torch.where(den > 1e-12, (f * df).sum(-1) / torch.clamp(den, min=1e-12), torch.zeros_like(den))
            gamma = torch.clamp(gamma, -9.0, 0.0)
            if have_prev:
                gamma = torch.where((f * f).sum(-1) <= (prev_f * prev_f).sum(-1), gamma, torch.zeros_like(gamma))
            else:
                gamma = torch.zeros_like(gamma)
            accel = new_pose - gamma[:, None] * (new_pose - prev_g)
            next_pose = torch.where(torch.isfinite(accel).all(-1, keepdim=True), accel, new_pose)
            prev_f, prev_g, have_prev = f, new_pose, True
        else:
            next_pose = new_pose
        err = torch.where(w > 0, dist, torch.zeros_like(dist)).sum(-1) / torch.clamp((w > 0).sum(-1), min=1)
        converged = (prev_err - err).abs() < cfg.tolerance
        pose = torch.where(done[:, None], pose, next_pose)
        iters = iters + (~done).to(torch.int32)
        prev_err, done = err, done | converged

    dist, _ = nearest_neighbor(geo.se2_apply(pose, src_xy), tgt_xy, tgt_valid, src_valid)
    inlier = src_valid & (dist < cfg.threshold_mm)
    n_in = inlier.sum(-1).to(torch.int32)
    rmse = torch.sqrt(torch.where(inlier, dist * dist, torch.zeros_like(dist)).sum(-1) / torch.clamp(n_in, min=1))
    return pose, rmse, n_in, iters


def icp_masked(src_xy, src_valid, tgt_xy, tgt_valid, init_pose,
               cfg: IcpConfig = IcpConfig()) -> RegistrationResult:
    """Masked fixed-shape ICP aligning ``src`` (sensor frame) onto ``tgt``
    (map frame) from ``init_pose``: ``(B, N, 2)/(B, N)/(B, M, 2)/(B, M)``
    tensors and ``(B, 3)`` poses on one device."""
    check_supported(cfg)
    init_pose = init_pose.to(torch.float32)
    n_src = src_valid.sum(-1)
    n_tgt = tgt_valid.sum(-1)
    if _uses_k1(cfg):
        pose, rmse, n_in, n_iters = icp_fused(
            src_xy, src_valid, tgt_xy, tgt_valid, init_pose,
            iters=cfg.max_iterations, threshold_mm=cfg.threshold_mm,
            tolerance=cfg.tolerance, anderson=cfg.anderson,
        )
    else:
        pose, rmse, n_in, n_iters = _general_loop(src_xy, src_valid, tgt_xy, tgt_valid, init_pose, cfg)
    degenerate = (n_src < cfg.min_points) | (n_tgt < cfg.min_points) | (n_in == 0)
    rmse = torch.where(degenerate, torch.full_like(rmse, float("inf")), rmse)
    pose = torch.where(degenerate[:, None], init_pose, pose)
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


def _one(src_xy, src_valid, tgt_xy, tgt_valid, init_pose, cfg: IcpConfig) -> RegistrationResult:
    """`icp_masked` on one registration (tensors without the leading axis)."""
    res = icp_masked(*(x[None].contiguous() for x in (src_xy, src_valid, tgt_xy, tgt_valid, init_pose)), cfg)
    return RegistrationResult(*(x[0] for x in res))


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
    return _one(s, sv, t, tv, init, cfg)


def register(src_points, dst_points, init_pose=None, cfg: IcpConfig = IcpConfig(), device=None):
    """``register(src, dst) -> (R (2, 2), t (2,) mm, rmse)`` as numpy/float."""
    res = icp(src_points, dst_points, init_pose=init_pose, cfg=cfg, device=device)
    r = geo.se2_rotation(res.pose)
    return r.cpu().numpy(), res.pose[:2].cpu().numpy(), float(res.rmse)


def gicp(points1, points2, threshold: float = 200.0, voxel_size: float = 20.0, trans_init=None, device=None):
    """Parity with the reference's ``gicp`` wrapper: voxel-downsample both
    clouds, register with the ``gicp`` estimator from ``trans_init`` (a 4 x 4
    matrix or an SE(2) triple), return ``(inlier_rmse, T (4, 4) float64)``.
    Fewer than 10 points on either side returns ``(inf, eye(4))``.
    ``device=None`` means the card."""
    p1 = np.asarray(points1, dtype=np.float32)
    p2 = np.asarray(points2, dtype=np.float32)
    if len(p1) < 10 or len(p2) < 10:
        return float("inf"), np.eye(4)
    dev = resolve_device(device)
    cfg = IcpConfig(threshold_mm=float(threshold), voxel_size_mm=float(voxel_size), estimator="gicp")
    s, sv = _pad_points(p1, -(-len(p1) // 8) * 8, dev)
    t, tv = _pad_points(p2, -(-len(p2) // 128) * 128, dev)
    s, sv = voxel_downsample(s, sv, cfg.voxel_size_mm)
    t, tv = voxel_downsample(t, tv, cfg.voxel_size_mm)
    if trans_init is None:
        init = geo.se2_identity(dev)
    else:
        ti = torch.as_tensor(np.asarray(trans_init, np.float32), device=dev)
        init = geo.mat44_to_se2(ti) if ti.shape == (4, 4) else ti
    res = _one(s, sv, t, tv, init, cfg)
    return float(res.rmse), geo.se2_to_mat44(res.pose).cpu().numpy().astype(np.float64)
