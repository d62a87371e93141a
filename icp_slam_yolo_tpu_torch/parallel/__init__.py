"""Fleets: many robots in one step, each with its own map (`fleet`) or all
building one map (`shared`), on one card or sharded over the ranks of a
``torch.distributed`` mesh (`distributed`: process start and the
collectives; `mesh`: the mesh and a rank's block of a batch)."""

from icp_slam_yolo_tpu_torch.parallel.distributed import (
    global_fleet_mesh,
    initialize,
    process_local_batch_size,
)
from icp_slam_yolo_tpu_torch.parallel.mesh import batch_sharding, make_mesh, rank_block, replicated

__all__ = ["batch_sharding", "global_fleet_mesh", "initialize", "make_mesh", "process_local_batch_size",
           "rank_block", "replicated"]
