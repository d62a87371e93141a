"""Carry SLAM state between the JAX package and the port.

SLAM has no weights: its state (pose, map buffer, occupancy grid, previous
scan, counters) is what moves.  The field names are those of the JAX
``SlamState`` and of the ``.npz`` that its ``Slam.save_state`` writes.
"""

from __future__ import annotations

import numpy as np
import torch

from icp_slam_yolo_tpu_torch.slam.pipeline import SlamState

_DTYPES = {
    "pose": torch.float32, "prev_pose": torch.float32, "map_xy": torch.float32,
    "map_valid": torch.bool, "occ": torch.float32, "prev_xy": torch.float32,
    "prev_valid": torch.bool, "step": torch.int32, "maint_count": torch.int32,
    "reject_run": torch.int32,
}


def state_from_numpy(arrays, device) -> SlamState:
    """A mapping of numpy arrays (a JAX ``SlamState._asdict()`` or a loaded
    ``.npz``; one robot's, or a fleet's with a leading robot axis on every
    field) -> the port's state on ``device``.  States saved before the
    motion-model and reseed fields default them as the JAX loader does."""
    fields = {k: np.asarray(arrays[k]) for k in arrays.keys()}
    fields.setdefault("prev_pose", fields["pose"])
    fields.setdefault("reject_run", np.int32(0))
    return SlamState(**{
        name: torch.as_tensor(np.array(fields[name]), dtype=dt, device=device)
        for name, dt in _DTYPES.items()
    })


def state_to_numpy(state: SlamState) -> dict:
    """The port's state -> a dict of numpy arrays with the JAX field names."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}
