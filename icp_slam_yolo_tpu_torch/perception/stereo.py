"""Stereo triangulation and pallet pose/alignment geometry, on tensors.

The counterpart of the JAX package's ``perception/stereo.py``:
  * `stereo_to_3d`: corner-wise disparity triangulation, ``Z = f*B/|xL - xR|``,
    ``X = (xL - cx) Z / f``, ``Y = (yL - cy) Z / f`` (a zero disparity counts
    as 1e-6);
  * `pallet_orientation_and_distance`: the plane normal from the cross
    product of two corner edges, flipped to +z, yaw ``atan2(n_x, n_z)``,
    depth the corners' mean Z;
  * `pallet_alignment`: the horizontal angle to the centre, a px -> mm scale
    from the known 110 mm pallet width foreshortened by the yaw, the lateral
    offset and a left/centre/right code (thresholds +-5 degrees).

Float32, on the device of the inputs (numpy arrays: the CPU).  Default
intrinsics: f = 381, cx = 320, cy = 240, B = 26 (`config.py`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from icp_slam_yolo_tpu_torch.config import STEREO_BASELINE, STEREO_CX, STEREO_CY, STEREO_F

PALLET_WIDTH_MM = 110.0     # known object width
LATERAL_OFFSET_BIAS = 13.0  # lateral offset = delta_x / px_per_mm - 13
ALIGN_DEG_THRESHOLD = 5.0   # left/right classification


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)


def stereo_to_3d(points_left, points_right, f=STEREO_F, cx=STEREO_CX, cy=STEREO_CY, b=STEREO_BASELINE):
    """``(N, 2)`` pixel corners in both views -> ``(N, 3)`` camera-frame mm."""
    pl, pr = _f32(points_left), _f32(points_right)
    disparity = torch.abs(pl[:, 0] - pr[:, 0])
    disparity = torch.where(disparity == 0, torch.full_like(disparity, 1e-6), disparity)
    z = (f * b) / disparity
    x = (pl[:, 0] - cx) * z / f
    y = (pl[:, 1] - cy) * z / f
    return torch.stack([x, y, z], dim=1)


def pallet_orientation_and_distance(corners_3d):
    """``(4, 3)`` corner points -> ``(normal (3,), yaw_rad, mean_depth)``."""
    c = _f32(corners_3d)
    normal = torch.linalg.cross(c[1] - c[0], c[2] - c[0])
    normal = normal / torch.clamp(torch.linalg.norm(normal), min=1e-9)
    normal = torch.where(normal[2] < 0, -normal, normal)
    yaw = torch.atan2(normal[0], normal[2])
    return normal, yaw, torch.mean(c[:, 2])


class PalletAlignment(NamedTuple):
    horizontal_angle_rad: torch.Tensor  # angle to pallet centre (atan2(X, Z))
    lateral_offset_mm: torch.Tensor     # signed offset from camera axis
    yaw_rad: torch.Tensor
    distance_mm: torch.Tensor
    direction: torch.Tensor             # -1 left / 0 centre / +1 right (int32)


def pallet_alignment(corners_left, corners_right, f=STEREO_F, cx=STEREO_CX, cy=STEREO_CY, b=STEREO_BASELINE):
    """The pallet alignment readout from stereo corner pairs."""
    c3d = stereo_to_3d(corners_left, corners_right, f, cx, cy, b)
    _, yaw, depth = pallet_orientation_and_distance(c3d)
    center = torch.mean(c3d, dim=0)
    horiz = torch.atan2(center[0], center[2])
    # px -> mm from the known pallet width foreshortened by the yaw
    cl = _f32(corners_left)
    px_width = torch.clamp(torch.max(cl[:, 0]) - torch.min(cl[:, 0]), min=1e-6)
    eff_width = PALLET_WIDTH_MM * torch.abs(torch.cos(yaw))
    px_per_mm = px_width / torch.clamp(eff_width, min=1e-6)
    lateral = (torch.mean(cl[:, 0]) - cx) / px_per_mm - LATERAL_OFFSET_BIAS
    deg = horiz * (180.0 / math.pi)
    direction = torch.where(deg < -ALIGN_DEG_THRESHOLD, -1, torch.where(deg > ALIGN_DEG_THRESHOLD, 1, 0))
    return PalletAlignment(horiz, lateral, yaw, depth, direction.to(torch.int32))
