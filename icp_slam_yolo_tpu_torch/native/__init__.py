"""Native (C++) runtime components: the robot comm link and the batched scan
loader; the counterpart of the JAX package's ``native/``.

The sources are the repository's ``native/robotlink.cpp`` and
``native/scanloader.cpp``; they are compiled with ``g++`` on first use into
``icp_slam_yolo_tpu_torch/_build/native/`` (rebuilt when a source is newer
than its library).  The scan loader falls back to Python without ``g++``.
"""

from icp_slam_yolo_tpu_torch.native.build import build_library, library_available

__all__ = ["build_library", "library_available"]
