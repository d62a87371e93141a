"""Sensor acquisition: the LiDAR scanner and its backends, scan recording, camera capture."""

from icp_slam_yolo_tpu_torch.acquisition.lidar import LidarScanner, ReplayLidar, ScanRecorder

__all__ = ["LidarScanner", "ReplayLidar", "ScanRecorder"]
