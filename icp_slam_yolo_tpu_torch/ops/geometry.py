"""Scan geometry: polar gating/conversion and SE(2) rigid transforms.

Counterpart of the JAX package's ``ops/geometry.py``.  Nothing here compacts
tensors: points stay in place with a validity mask, so every shape is static
and no function synchronises with the host.

Poses are SE(2) triples ``(x_mm, y_mm, theta_rad)`` as ``(..., 3)`` float32
tensors.  Every function takes leading batch axes (the fleet's robot axis):
points are ``(..., N, 2)`` and poses ``(..., 3)`` with equal leading shapes.
"""

from __future__ import annotations

import torch

from icp_slam_yolo_tpu_torch.config import GateConfig


def polar_to_cartesian(scan: torch.Tensor, gate: GateConfig):
    """Raw polar rows ``(..., N, 3)`` ``[quality, angle_deg, distance_mm]`` ->
    ``(xy (..., N, 2) float32 mm, valid (..., N) bool)``; invalid points are zeroed.

    Keeps a point iff ``min_dist < d < max_dist and quality > min_quality``
    and, with ``front_arc_only``, ``angle <= lo or angle >= hi``; converts
    with ``x = d cos(a)``, ``y = y_sign d sin(a)``.
    """
    quality, angle, dist = scan[..., 0], scan[..., 1], scan[..., 2]
    valid = (dist > gate.min_dist_mm) & (dist < gate.max_dist_mm) & (quality > gate.min_quality)
    if gate.front_arc_only:
        valid &= (angle <= gate.front_arc_lo_deg) | (angle >= gate.front_arc_hi_deg)
    rad = torch.deg2rad(angle)
    x = dist * torch.cos(rad)
    y = gate.y_sign * dist * torch.sin(rad)
    xy = torch.stack([x, y], dim=-1).to(torch.float32)
    xy = torch.where(valid[..., None], xy, torch.zeros((), dtype=xy.dtype, device=xy.device))
    return xy, valid


def se2_identity(device=None) -> torch.Tensor:
    return torch.zeros(3, dtype=torch.float32, device=device)


def se2_rotation(pose: torch.Tensor) -> torch.Tensor:
    """``(..., 2, 2)`` rotation matrix of an SE(2) pose."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def se2_apply(pose: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """``R p + t`` for ``(..., N, 2)`` points under ``(..., 3)`` poses, written
    elementwise."""
    c, s = torch.cos(pose[..., 2:3]), torch.sin(pose[..., 2:3])
    x, y = xy[..., 0], xy[..., 1]
    return torch.stack([c * x - s * y + pose[..., 0:1], s * x + c * y + pose[..., 1:2]], dim=-1)


def se2_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a ∘ b`` (apply ``b`` first, then ``a``)."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x, y = b[..., 0], b[..., 1]
    return torch.stack([c * x - s * y + a[..., 0], s * x + c * y + a[..., 1], a[..., 2] + b[..., 2]], dim=-1)


def se2_inverse(pose: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    x, y = pose[..., 0], pose[..., 1]
    return torch.stack([-(c * x + s * y), -(-s * x + c * y), -pose[..., 2]], dim=-1)


def se2_extrapolate(pose: torch.Tensor, prev_pose: torch.Tensor) -> torch.Tensor:
    """Constant-velocity prediction: ``(pose ∘ prev_pose⁻¹) ∘ pose``; equals
    ``pose`` when ``prev_pose == pose`` (the reference's static init)."""
    delta = se2_compose(pose, se2_inverse(prev_pose))
    return se2_compose(delta, pose)


def se2_to_mat44(pose: torch.Tensor) -> torch.Tensor:
    """SE(2) ``(3,)`` -> 4x4 homogeneous matrix (the reference's pose format)."""
    m = torch.eye(4, dtype=pose.dtype, device=pose.device)
    m[:2, :2] = se2_rotation(pose)
    m[:2, 3] = pose[:2]
    return m


def mat44_to_se2(m: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous matrix -> SE(2) ``(3,)``."""
    return torch.stack([m[0, 3], m[1, 3], torch.atan2(m[1, 0], m[0, 0])]).to(torch.float32)


def transform_points(points: torch.Tensor, rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """``points @ R.T + t`` for ``(N, D)`` points, a ``(D, D)`` rotation and
    a ``(D,)`` translation (any dimension)."""
    return points @ rotation.T + translation


def masked_mean(xy: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean over the valid points of ``(..., N, 2)``; zero when none is valid."""
    w = valid.to(xy.dtype)
    denom = torch.clamp(w.sum(-1), min=1.0)
    return (xy * w[..., None]).sum(-2) / denom[..., None]
