"""Fleet-batched SLAM: many robots / scan streams in one step, on one card
or sharded over the ranks of a mesh.

Counterpart of the JAX package's ``parallel/fleet.py``.  There ``vmap`` adds
the robot axis; here the step is written over it (`slam/pipeline.
make_batched_step`), so one fleet step launches each kernel once for all
robots of a card.  Over several ranks (`fleet_run_sharded`, a mesh from
`parallel/mesh.py`) each rank replays its block of the robots on its own
card; the only collective is the fleet's statistics in `make_fleet_step`,
which XLA inserts from the sharding annotations in JAX and which is an
explicit all-reduce here.
"""

from __future__ import annotations

import numpy as np
import torch

from icp_slam_yolo_tpu_torch.config import SlamConfig
from icp_slam_yolo_tpu_torch.device import resolve_device
from icp_slam_yolo_tpu_torch.parallel.distributed import all_sum_
from icp_slam_yolo_tpu_torch.parallel.mesh import make_mesh, mesh_device, rank_block
from icp_slam_yolo_tpu_torch.slam import pipeline
from icp_slam_yolo_tpu_torch.utils.profiling import span


def fleet_init(first_scans: torch.Tensor, cfg: SlamConfig) -> pipeline.SlamState:
    """``(B, n_max, 3)`` first scans -> batched `SlamState`."""
    return pipeline.init_fleet_state(first_scans, cfg)


def make_fleet_step(cfg: SlamConfig, mesh=None):
    """Batched ``step``: ``(states, scans (B, n, 3)[, tick]) -> (states, outs,
    fleet_stats)``.  ``fleet_stats`` holds the mean finite RMSE and the accept
    rate over the fleet, as device tensors; with a ``mesh``, ``states`` and
    ``scans`` are this rank's block of the robots and the statistics are the
    whole fleet's: one all-reduce of (the sum of the finite RMSEs, their
    count, the accepted count, the robot count) over the mesh's ``data``
    axis, then the same divisions.  The step owns the ``states`` it
    is given: their grid is updated in place (K4) and comes back in the new
    states, so the old ones must not be used again.

    ``tick`` (optional host integer) is the fleet-uniform maintenance counter:
    pass a running sequence index to keep the realtime prune/downsample
    cadence a host branch; callers that omit it fall back to the per-robot
    counter on the device (select semantics: correct, slower).

    The step and the statistics lie under the root span ``slam.step``
    (`utils/profiling.span`), the step's stages under it.
    """
    step = pipeline.make_batched_step(cfg)
    group = None if mesh is None else mesh.get_group("data")

    def fleet_step(states, scans, tick=None):
        with span("slam.step", scans.device):
            states, outs = step(states, scans, tick)
            finite = torch.isfinite(outs.rmse)
            rmse_sum = torch.where(finite, outs.rmse, torch.zeros_like(outs.rmse)).sum()
            if group is None:
                mean_rmse = rmse_sum / torch.clamp(finite.sum(), min=1)
                stats = {"mean_rmse": mean_rmse, "accept_rate": outs.accepted.to(torch.float32).mean()}
            else:
                sums = all_sum_(torch.stack([rmse_sum, finite.sum().to(torch.float32),
                                             outs.accepted.sum().to(torch.float32),
                                             rmse_sum.new_full((), float(outs.accepted.shape[0]))]), group)
                stats = {"mean_rmse": sums[0] / torch.clamp(sums[1], min=1), "accept_rate": sums[2] / sums[3]}
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
    pipeline.check_supported_config(cfg, dev)
    step = pipeline.make_batched_step(cfg)
    states = fleet_init(scans[:, 0], cfg)
    outs = []
    for t in range(1, scans.shape[1]):
        states, out = step(states, scans[:, t], t - 1)
        outs.append(out)
    return states, pipeline.StepOutput(*(torch.stack(f, dim=1) for f in zip(*outs)))


def fleet_run_sharded(scans, cfg: SlamConfig, mesh=None, device=None):
    """Shard the fleet axis over ``mesh``'s ``data`` axis and replay: every
    rank is given the whole ``(B, T, n_max, 3)`` stack and replays its block
    of the robots (`mesh.rank_block`) with the batched step on its own
    device (``device``: default the mesh's device on this rank), so K1, K3
    and K4 run once a step for its robots.  ``B`` must divide by the axis
    size (ValueError otherwise).  Returns ``(final_states, outputs)`` of the
    rank's block, as JAX's outputs stay sharded on the batch axis.

    ``mesh=None`` takes a mesh over every rank of the process group
    (`make_mesh`); a process without a group replays the whole fleet alone
    on ``device`` (None: the card), as JAX's does on one device.
    """
    if mesh is None and not torch.distributed.is_initialized():
        return fleet_run_sequence(scans, cfg, device)
    mesh = mesh or make_mesh()
    return fleet_run_sequence(scans[rank_block(scans.shape[0], mesh)], cfg, device or mesh_device(mesh))
