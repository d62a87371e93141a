"""SLAM x perception fusion: detections as semantic landmarks in the map frame."""

from icp_slam_yolo_tpu_torch.fusion.landmarks import Landmark, LandmarkMap, fuse_stereo_pair, project_detection

__all__ = ["Landmark", "LandmarkMap", "fuse_stereo_pair", "project_detection"]
