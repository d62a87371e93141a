"""Fleet-batched SLAM: many robots / scan streams in one step on one card.

Counterpart of the JAX package's ``parallel/fleet.py``.  There ``vmap`` adds
the robot axis; here the step is written over it (`slam/pipeline.
make_batched_step`), so one fleet step launches each kernel once for all
robots.  Sharding the robot axis over several cards (`fleet_run_sharded`) is
not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from icp_slam_yolo_tpu_torch.config import SlamConfig
from icp_slam_yolo_tpu_torch.device import resolve_device
from icp_slam_yolo_tpu_torch.slam import pipeline


def fleet_init(first_scans: torch.Tensor, cfg: SlamConfig) -> pipeline.SlamState:
    """``(B, n_max, 3)`` first scans -> batched `SlamState`."""
    return pipeline.init_fleet_state(first_scans, cfg)


def make_fleet_step(cfg: SlamConfig):
    """Batched ``step``: ``(states, scans (B, n, 3)[, tick]) -> (states, outs,
    fleet_stats)``.  ``fleet_stats`` holds the mean finite RMSE and the accept
    rate over the fleet, as device tensors.  The step owns the ``states`` it
    is given: their grid is updated in place (K4) and comes back in the new
    states, so the old ones must not be used again.

    ``tick`` (optional host integer) is the fleet-uniform maintenance counter:
    pass a running sequence index to keep the realtime prune/downsample
    cadence a host branch; callers that omit it fall back to the per-robot
    counter on the device (select semantics: correct, slower).
    """
    step = pipeline.make_batched_step(cfg)

    def fleet_step(states, scans, tick=None):
        states, outs = step(states, scans, tick)
        finite = torch.isfinite(outs.rmse)
        mean_rmse = torch.where(finite, outs.rmse, torch.zeros_like(outs.rmse)).sum() / torch.clamp(finite.sum(), min=1)
        stats = {"mean_rmse": mean_rmse, "accept_rate": outs.accepted.to(torch.float32).mean()}
        return states, outs, stats

    return fleet_step


def fleet_run_sequence(scans, cfg: SlamConfig = SlamConfig(), device=None):
    """Replay ``(B, T, n_max, 3)`` scan stacks for ``B`` robots on ``device``
    (``None`` means the card): scan 0 of each stream seeds its robot, scans
    1..T-1 run through the batched step with the sequence index as the
    fleet-uniform maintenance ``tick`` (identical to a per-robot sequential
    replay whenever no robot skips a scan for lack of gated points).

    Returns ``(final_states, outputs)`` with ``(B, T-1, ...)`` output fields.
    """
    dev = resolve_device(device)
    if not isinstance(scans, torch.Tensor):
        scans = torch.from_numpy(np.ascontiguousarray(scans, dtype=np.float32))
    scans = scans.to(device=dev, dtype=torch.float32)
    if scans.shape[1] < 2:
        raise ValueError("fleet_run_sequence needs at least two scans per robot")
    step = pipeline.make_batched_step(cfg)
    states = fleet_init(scans[:, 0], cfg)
    outs = []
    for t in range(1, scans.shape[1]):
        states, out = step(states, scans[:, t], t - 1)
        outs.append(out)
    return states, pipeline.StepOutput(*(torch.stack(f, dim=1) for f in zip(*outs)))


def fleet_run_sharded(scans, cfg: SlamConfig, mesh=None):
    """Not ported: sharding the robot axis over several cards needs
    ``torch.distributed`` (ROADMAP.md 'Open items' 1, item 7b:
    ``mesh.py``, ``distributed.py``)."""
    raise NotImplementedError(
        "fleet_run_sharded waits for ROADMAP.md 'Open items' 1, item 7b: the "
        "multi-card mesh on torch.distributed; use fleet_run_sequence on one card"
    )
