"""Oriented-box pose heuristics and planar PnP, on tensors: the counterpart
of the JAX package's ``perception/obb_pose.py``.

  * `analyze_object_pose`: sort 4 corners into tl/tr/bl/br, classify the
    position by the centre's x in thirds (threshold 0.15 x width), the
    rotation by the left/right side-length ratio (> 1.2 / < 0.8), the roll
    from the bottom edge;
  * `estimate_3d_pose`: a planar object's pose from its homography (DLT on
    4 correspondences, then orthonormalisation), returning (R, t,
    euler_deg).

Positions and rotations are integer codes (`POSITION_NAMES`,
`ROTATION_NAMES` map them to strings): position -1 left / 0 centre / +1
right; rotation -1 left / 0 square / +1 right.  Float32, on the device of
the inputs (numpy arrays: the CPU).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

POSITION_NAMES = {-1: "left", 0: "center", 1: "right"}
ROTATION_NAMES = {-1: "rotated_left", 0: "square", 1: "rotated_right"}


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)


def _deg(rad: torch.Tensor) -> torch.Tensor:
    return rad * (180.0 / math.pi)


def sort_corners(coords) -> torch.Tensor:
    """``(4, 2)`` corners in any order -> rows [tl, tr, bl, br]."""
    c = _f32(coords)
    order_y = torch.argsort(c[:, 1], stable=True)
    top, bot = c[order_y[:2]], c[order_y[2:]]
    top = top[torch.argsort(top[:, 0], stable=True)]
    bot = bot[torch.argsort(bot[:, 0], stable=True)]
    return torch.stack([top[0], top[1], bot[0], bot[1]])


class ObbPose(NamedTuple):
    position: torch.Tensor  # -1/0/+1
    rotation: torch.Tensor  # -1/0/+1
    roll_deg: torch.Tensor


def analyze_object_pose(coords, image_width: float, ratio_hi: float = 1.2, ratio_lo: float = 0.8) -> ObbPose:
    tl, tr, bl, br = sort_corners(coords)
    center_x = torch.mean(_f32(coords)[:, 0])
    image_width = _f32(image_width)
    thresh = image_width * 0.15
    position = torch.where(center_x < image_width / 2 - thresh, -1,
                           torch.where(center_x > image_width / 2 + thresh, 1, 0))
    ratio = torch.linalg.norm(tl - bl) / torch.clamp(torch.linalg.norm(tr - br), min=1e-6)
    rotation = torch.where(ratio > ratio_hi, 1, torch.where(ratio < ratio_lo, -1, 0))
    bottom = br - bl
    return ObbPose(position.to(torch.int32), rotation.to(torch.int32), _deg(torch.atan2(bottom[1], bottom[0])))


def _homography_dlt(obj_xy: torch.Tensor, img_xy: torch.Tensor) -> torch.Tensor:
    """Plane -> image homography from 4 correspondences: the null vector of
    the (8, 9) DLT system (the last right singular vector), scaled so that
    ``H[2, 2] = 1`` unless it is ~0."""
    zero, one = torch.zeros((), dtype=obj_xy.dtype), torch.ones((), dtype=obj_xy.dtype)
    rows = []
    for i in range(4):
        x, y = obj_xy[i, 0], obj_xy[i, 1]
        u, v = img_xy[i, 0], img_xy[i, 1]
        rows.append(torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u]))
        rows.append(torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v]))
    _, _, vt = torch.linalg.svd(torch.stack(rows))
    h = vt[-1]
    return (h / torch.where(torch.abs(h[8]) > 1e-12, h[8], one)).reshape(3, 3)


def estimate_3d_pose(image_points, object_dims: tuple, camera_matrix):
    """Planar 4-point pose (the homography route).

    Args:
      image_points: ``(4, 2)`` pixels ordered [tl, tr, br, bl], like the
        object template ``[(0, h), (w, h), (w, 0), (0, 0)]``.
      object_dims: ``(w_mm, h_mm)`` of the planar object (110 x 15 for the
        pallet face).
      camera_matrix: ``(3, 3)`` intrinsics.

    Returns ``(R (3, 3), t (3,), euler_deg (3,))`` with z forced positive.
    """
    w, h = object_dims
    obj = _f32([[0.0, h], [w, h], [w, 0.0], [0.0, 0.0]])
    hmg = _homography_dlt(obj, _f32(image_points))
    b = torch.linalg.inv(_f32(camera_matrix)) @ hmg
    b = b * (2.0 / torch.clamp(torch.linalg.norm(b[:, 0]) + torch.linalg.norm(b[:, 1]), min=1e-9))
    b = torch.where(b[2, 2] < 0, -b, b)  # the object in front of the camera
    r1, r2, t = b[:, 0], b[:, 1], b[:, 2]
    u, _, vt = torch.linalg.svd(torch.stack([r1, r2, torch.linalg.cross(r1, r2)], dim=1))
    d = torch.sign(torch.linalg.det(u @ vt))
    r = u @ torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d])) @ vt
    # Euler (xyz, degrees), cv2.decomposeProjectionMatrix's convention
    sy = torch.sqrt(r[0, 0] ** 2 + r[1, 0] ** 2)
    euler = _deg(torch.stack([torch.atan2(r[2, 1], r[2, 2]), torch.atan2(-r[2, 0], sy), torch.atan2(r[1, 0], r[0, 0])]))
    return r, t, euler


def mono_pose_from_corners(corners, camera_matrix, object_dims: tuple = (110.0, 15.0)) -> dict:
    """Single-camera 3-D pallet pose from ordered corners.

    Args:
      corners: ``(4, 2)`` pixel corners in [tl, tr, br, bl] order (what the
        pose task's ``Detector`` returns in ``out["keypoints"]``, without
        the visibility column).
      camera_matrix: ``(3, 3)`` intrinsics.
      object_dims: the planar object's ``(w_mm, h_mm)``.

    Returns a dict: rotation ``R``, translation ``t`` (mm, camera frame),
    ``euler_deg``, ``distance_mm`` (the norm of t), ``yaw_deg`` (the
    horizontal angle to the object centre, ``atan2(X, Z)``), and the
    `analyze_object_pose` position/rotation codes and roll of the corners.
    """
    c = _f32(corners)
    r, t, euler = estimate_3d_pose(c, object_dims, camera_matrix)
    yaw = _deg(torch.atan2(t[0], torch.clamp(t[2], min=1e-6)))
    obb = analyze_object_pose(c, 2.0 * _f32(camera_matrix)[0, 2])  # frame width from cx = w / 2
    return {
        "R": r, "t": t, "euler_deg": euler, "distance_mm": torch.linalg.norm(t), "yaw_deg": yaw,
        "position": obb.position, "rotation": obb.rotation, "roll_deg": obb.roll_deg,
    }


def project_points(points_3d, r, t, camera_matrix) -> torch.Tensor:
    """Pinhole projection of ``(N, 3)`` object points through ``(R, t)``."""
    uvw = (_f32(points_3d) @ _f32(r).T + _f32(t)) @ _f32(camera_matrix).T
    return uvw[:, :2] / torch.clamp(uvw[:, 2:3], min=1e-9)
