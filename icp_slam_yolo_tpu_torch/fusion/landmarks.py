"""Project stereo pallet detections through the robot pose into the map
frame: the counterpart of the JAX package's ``fusion/landmarks.py``, the
last step of the fused SLAM + detect tick (``BASELINE.json`` configuration
4: ICP pose + detections projected into the occupancy grid as semantic
landmarks).

Geometry: the stereo camera frame has +Z forward and +X right; the robot
(LiDAR) frame has +X forward and +Y left.  A detection at camera (X, Z)
lands at robot ``(Z + mount_forward, -X + mount_left)`` and is then pushed
through the SE(2) robot pose into world mm.  Host math on Python floats.

`fuse_stereo_pair` is the perception loop's step after a stereo pair's
detect (the JAX package runs it in its server's camera worker): the first
detection of each eye, its four keypoint corners where the pose task gives
them all with visibility >= 0.5 and its box corners otherwise, the pallet
alignment, and the landmark at the robot's pose.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from icp_slam_yolo_tpu_torch.perception.stereo import PalletAlignment, pallet_alignment


@dataclasses.dataclass
class Landmark:
    xy_mm: tuple[float, float]   # world position
    yaw_rad: float               # world yaw of the pallet face
    class_id: int
    score: float
    n_obs: int = 1


def camera_to_robot(point_cam_mm, mount_forward_mm: float = 0.0, mount_left_mm: float = 0.0):
    """Camera (X right, Y down, Z forward) -> robot (x forward, y left)."""
    x_cam, _, z_cam = point_cam_mm
    return (z_cam + mount_forward_mm, -x_cam + mount_left_mm)


def robot_to_world(pose_se2, point_robot):
    x, y, theta = pose_se2
    c, s = math.cos(theta), math.sin(theta)
    px, py = point_robot
    return (c * px - s * py + x, s * px + c * py + y)


def project_detection(pose_se2, corners_left: np.ndarray, corners_right: np.ndarray, class_id: int = 0,
                      score: float = 1.0, mount_forward_mm: float = 0.0, mount_left_mm: float = 0.0,
                      alignment=None) -> Landmark:
    """Stereo corner detections + robot pose -> world-frame landmark.  Pass
    ``alignment`` to reuse an already computed `pallet_alignment`."""
    align = alignment if alignment is not None else pallet_alignment(corners_left, corners_right)
    center_cam = (
        float(np.tan(float(align.horizontal_angle_rad)) * float(align.distance_mm)),
        0.0,
        float(align.distance_mm),
    )
    world_xy = robot_to_world(pose_se2, camera_to_robot(center_cam, mount_forward_mm, mount_left_mm))
    return Landmark(xy_mm=world_xy, yaw_rad=float(pose_se2[2]) + float(align.yaw_rad), class_id=class_id,
                    score=score)


class LandmarkMap:
    """Accumulates landmarks with distance-based association and averaging."""

    def __init__(self, merge_radius_mm: float = 500.0):
        self.merge_radius_mm = merge_radius_mm
        self.landmarks: list[Landmark] = []

    def insert(self, lm: Landmark) -> int:
        """Merge into the nearest same-class landmark within the radius, else
        add.  Returns the landmark's index."""
        best, best_d = None, self.merge_radius_mm
        for i, other in enumerate(self.landmarks):
            if other.class_id != lm.class_id:
                continue
            d = math.hypot(other.xy_mm[0] - lm.xy_mm[0], other.xy_mm[1] - lm.xy_mm[1])
            if d < best_d:
                best, best_d = i, d
        if best is None:
            self.landmarks.append(lm)
            return len(self.landmarks) - 1
        o = self.landmarks[best]
        n = o.n_obs + 1
        w = o.n_obs / n
        self.landmarks[best] = Landmark(
            xy_mm=(o.xy_mm[0] * w + lm.xy_mm[0] / n, o.xy_mm[1] * w + lm.xy_mm[1] / n),
            yaw_rad=o.yaw_rad * w + lm.yaw_rad / n,
            class_id=o.class_id,
            score=max(o.score, lm.score),
            n_obs=n,
        )
        return best

    def to_pixel_markers(self, map_cfg) -> list[dict]:
        """Landmarks as UI marker dicts in map pixel coordinates."""
        cx, cy = map_cfg.center_px
        res = map_cfg.resolution_mm_per_px
        return [
            {"px": int(cx + lm.xy_mm[0] / res), "py": int(cy - lm.xy_mm[1] / res), "yaw": lm.yaw_rad,
             "class": lm.class_id, "n_obs": lm.n_obs}
            for lm in self.landmarks
        ]


def _box_corners(b) -> np.ndarray:
    return np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]]])


def fuse_stereo_pair(out_left: dict, out_right: dict, pose_se2, landmarks: LandmarkMap
                     ) -> tuple[PalletAlignment, int] | None:
    """One stereo pair's detections (``Detector.detect_pair``'s two dicts)
    into ``landmarks`` at the robot pose ``(x_mm, y_mm, theta)``.  Returns
    the alignment and the landmark's index, or None where an eye has no
    detection."""
    if not len(out_left["boxes"]) or not len(out_right["boxes"]):
        return None
    # an occluded corner (low visibility) has an unreliable position: the box
    # corners, unless all four keypoints of both eyes are confident
    if ("keypoints" in out_left and "keypoints" in out_right
            and float(np.min(out_left["keypoints"][0][:, 2])) >= 0.5
            and float(np.min(out_right["keypoints"][0][:, 2])) >= 0.5):
        c1 = np.asarray(out_left["keypoints"][0][:, :2], np.float64)
        c2 = np.asarray(out_right["keypoints"][0][:, :2], np.float64)
    else:
        c1, c2 = _box_corners(out_left["boxes"][0]), _box_corners(out_right["boxes"][0])
    align = pallet_alignment(c1, c2)
    pose = tuple(map(float, pose_se2))
    idx = landmarks.insert(project_detection(pose, c1, c2, score=float(out_left["scores"][0]), alignment=align))
    return align, idx
