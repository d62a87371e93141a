"""icp_slam_yolo_tpu_torch: the SLAM scan -> pose -> map step in PyTorch + CUDA.

The PyTorch port of ``icp_slam_yolo_tpu`` (which stays the JAX reference).
Slice 1 holds the per-scan SLAM step (`slam/pipeline.make_step`) with its three
hand-written CUDA kernels for Hopper (``csrc/*.cu``): the fused ICP loop, the
occupancy raster update and the nearest-neighbour argmin.  Each kernel has a
plain PyTorch version beside it; a wrapper launches the kernel for a CUDA
tensor and runs the plain version only for a CPU tensor.

Entry points (`Slam`, `run_sequence`, `register`) take ``device=None``, which
means the card; without one they raise unless the caller passes
``device="cpu"``.
"""

import torch

# Geometry needs full float32: TF32 keeps ~3 decimal digits and would corrupt
# the ICP moments and distances (the JAX package forces precision=HIGHEST for
# the same reason).  Matmul TF32 is off by default; cuDNN's is on by default.
assert torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul must stay off"
torch.backends.cudnn.allow_tf32 = False

from icp_slam_yolo_tpu_torch.config import (  # noqa: E402
    FLEET_CONFIG,
    OFFLINE_CONFIG,
    PRESETS,
    REALTIME_CONFIG,
    GateConfig,
    IcpConfig,
    MapConfig,
    OccupancyConfig,
    SlamConfig,
)
from icp_slam_yolo_tpu_torch.core.registration import icp, icp_masked, register  # noqa: E402
from icp_slam_yolo_tpu_torch.slam.api import Slam  # noqa: E402
from icp_slam_yolo_tpu_torch.slam.pipeline import (  # noqa: E402
    SlamState,
    StepOutput,
    init_state,
    make_step,
    run_sequence,
    update_map,
)

__all__ = [
    "FLEET_CONFIG", "OFFLINE_CONFIG", "PRESETS", "REALTIME_CONFIG",
    "GateConfig", "IcpConfig", "MapConfig", "OccupancyConfig", "SlamConfig",
    "Slam", "SlamState", "StepOutput", "icp", "icp_masked", "init_state",
    "make_step", "register", "run_sequence", "update_map",
]
