"""icp_slam_yolo_tpu_torch: SLAM and pallet detection in PyTorch + CUDA.

The PyTorch port of ``icp_slam_yolo_tpu`` (which stays the JAX reference).
It holds the whole per-scan SLAM step (`slam/pipeline`: offline and realtime
semantics, the GICP rescue, the outlier filter, the reseed), written over a
robot axis, and the fleet paths above it (`parallel/fleet`: a map a robot;
`parallel/shared`: R robots building one map), on one card or sharded over
the ranks of a ``torch.distributed`` mesh (`parallel/distributed`,
`parallel/mesh`: one process a card, NCCL between cards), with four
hand-written CUDA kernels for Hopper (``csrc/*.cu``): the fused ICP loop, the
two occupancy raster updates and the nearest-neighbour argmin, each taking
all robots in one launch.  It also holds the pallet detector
(`models/detect.Detector`, `detector_from_checkpoint`; the v8, v11 and v12
families) with four more: the fused conv + bias + SiLU kernels (1x1, 3x3,
3x3 stride 2) and the whole-C2f kernel (v8's blocks).  Each kernel has a
plain PyTorch version beside it; a wrapper launches the kernel for a CUDA
tensor and runs the plain version only for a CPU tensor.  The stereo and
pose geometry (`perception`) and the landmark map (`fusion`) close the
fused SLAM + detect loop: a scan step, a stereo pair's detect, and the
detection projected at the new pose (`fusion.fuse_stereo_pair`).  The
entry points users run sit on top: the command line (`cli`: replay, serve,
detect, register, train, eval, label-check, labeler, split, comm-hub,
comm-send), the control-panel server (`serve`), the sensors
(`acquisition`: the LiDAR scanner and its recorder, the cameras), the robot
link and the batched scan loader (`native`: ctypes over ``g++``-built
C++), the stage spans and trace (`utils.profiling`), the map
and image files (`io.maps`, `io.render`, `utils.images`: PNG and JPEG in
and out without an imaging package, JPEG decoded to PIL's pixels), the
Ultralytics ``.pt`` import (`io.torch_import`) and the dataset-labeling
toolchain (`data`, `serve.labeler_app`).

Entry points (`Slam`, `run_sequence`, `fleet_run_sequence`, `fleet_run_sharded`, `shared_fleet_run`,
`register`, `gicp`, `Detector`, `detector_from_checkpoint`) take ``device=None``, which means the card (over a
mesh: the rank's card); without one they raise unless the caller passes ``device="cpu"``.  The training
step (`models.train.make_train_step`) also runs data-parallel over a mesh.
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
from icp_slam_yolo_tpu_torch.core.registration import RegistrationResult, gicp, icp, icp_masked, register  # noqa: E402
from icp_slam_yolo_tpu_torch.fusion import Landmark, LandmarkMap, fuse_stereo_pair, project_detection  # noqa: E402
from icp_slam_yolo_tpu_torch.models.detect import Detector, detector_from_checkpoint  # noqa: E402
from icp_slam_yolo_tpu_torch.perception.stereo import pallet_alignment  # noqa: E402
from icp_slam_yolo_tpu_torch.parallel.fleet import (  # noqa: E402
    fleet_init,
    fleet_run_sequence,
    fleet_run_sharded,
    make_fleet_step,
)
from icp_slam_yolo_tpu_torch.parallel import distributed, mesh  # noqa: E402
from icp_slam_yolo_tpu_torch.parallel.shared import SharedOutputs, shared_fleet_run  # noqa: E402
from icp_slam_yolo_tpu_torch.slam.api import Slam  # noqa: E402
from icp_slam_yolo_tpu_torch.slam.pipeline import (  # noqa: E402
    SlamState,
    StepOutput,
    init_state,
    make_batched_step,
    make_step,
    run_sequence,
    update_map,
)

__version__ = "0.1.0"

__all__ = [
    "FLEET_CONFIG", "OFFLINE_CONFIG", "PRESETS", "REALTIME_CONFIG",
    "GateConfig", "IcpConfig", "MapConfig", "OccupancyConfig", "SlamConfig",
    "Detector", "detector_from_checkpoint", "Landmark", "LandmarkMap", "fuse_stereo_pair", "pallet_alignment",
    "project_detection",
    "SharedOutputs", "Slam", "SlamState", "StepOutput", "fleet_init", "fleet_run_sequence", "fleet_run_sharded",
    "gicp", "icp", "icp_masked", "init_state", "make_batched_step", "make_fleet_step",
    "make_step", "register", "run_sequence", "update_map",
    "RegistrationResult", "distributed", "mesh", "__version__",
]
