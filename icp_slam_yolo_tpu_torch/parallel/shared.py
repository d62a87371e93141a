"""Collaborative shared-map SLAM: R robots building ONE map, on one card or
over the ranks of a mesh.

Counterpart of the JAX package's ``parallel/shared.py``.  There the robot
axis is sharded over a device mesh (one robot a device), the map and the
occupancy grid are replicated, and each step merges the robots'
contributions with collectives: a ``psum`` of log-odds deltas and an
``all_gather`` of insert candidates.  The layout here is the port's own: the
robots are the batch axis of the batched ops and kernels, so

* a step launches each kernel once for a card's robots: K1 (every robot
  registers against the same shared map), K3 (the dynamic-points filter
  against each robot's previous scan) and K4 (each robot's occupancy update,
  in place on its own copy of the shared base grid);
* on one card (no mesh) the ``all_gather(..., tiled=True)`` of the
  candidates is a concatenation in robot order, the ``psum`` a sum over the
  robot axis, and any ``R >= 1`` is taken;
* over a mesh, R robots divide over the W ranks of its ``data`` axis, R / W
  a rank in rank-major blocks (R = W is JAX's layout), and three
  collectives, in JAX's order, replace the sums and the concatenation: the
  occupancy merge (each rank sums its robots' log-ratio deltas, one
  all-reduce sums the ranks'), the insert candidates (concatenated in robot
  order over the ranks) and, on maintenance steps, the prune's anchor (the
  sum of every robot's position over R).  Every rank calls them in the same
  order: the tick is the same on all ranks, and the rescue's host read
  decides only the rank's own robots.  The map and the grid are replicated
  and stay bit-identical across the ranks, since every rank runs the same
  merge, maintenance and compaction on the same bits.

The step follows JAX's ``_robot_step`` and ``body``, not the single-map
pipeline (`slam/pipeline.make_batched_step`), which differs: it registers
against the whole map under a mask (no ``local_map_capacity`` compaction),
ignores ``reseed_after_rejects`` (a reseed would discard the whole fleet's
map), always deduplicates the candidates at ``duplicate_voxel_mm``, prunes
around the fleet's mean pose, runs the maintenance on a fleet-uniform tick
counted from 0, and seeds the map with every robot's first scan un-
downsampled at the identity pose.  The GICP rescue (``cfg.icp.
rescue_estimator``) is a host branch taken when some robot rejected: the
step's one host read, as in the batched pipeline; configurations without a
rescue make none.

The step's stage spans (`utils/profiling.span`) are the batched pipeline's,
under the root ``slam.step``; ``slam.occupancy`` holds the grid copies, K4
and the merge.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_slam_yolo_tpu_torch.config import MAP_MAINTENANCE_INTERVAL, SlamConfig
from icp_slam_yolo_tpu_torch.core.registration import RegistrationResult, icp_masked
from icp_slam_yolo_tpu_torch.device import resolve_device
from icp_slam_yolo_tpu_torch.ops import geometry as geo
from icp_slam_yolo_tpu_torch.ops.outliers import dynamic_points_mask, statistical_outlier_mask
from icp_slam_yolo_tpu_torch.ops.raster import occupancy_keep_mask, prune_keep_mask, update_occupancy
from icp_slam_yolo_tpu_torch.ops.voxel import compact, voxel_downsample
from icp_slam_yolo_tpu_torch.parallel.distributed import all_concat, all_sum_
from icp_slam_yolo_tpu_torch.parallel.mesh import mesh_device, rank_block
from icp_slam_yolo_tpu_torch.slam.pipeline import _rescue_icp_cfg, _where, check_supported_config
from icp_slam_yolo_tpu_torch.utils.profiling import span

P_EPS = 1e-6  # occupancy probabilities are clipped into [P_EPS, 1] before the log


class SharedOutputs(NamedTuple):
    """Per robot, per processed scan: scan 0 of each stream seeds the shared
    map, so ``(R, T, ...)`` scans give ``(R, T-1, ...)`` rows; row ``t`` is
    the result of scan ``t + 1``."""

    pose: torch.Tensor      # (R, T-1, 3)
    rmse: torch.Tensor      # (R, T-1)
    accepted: torch.Tensor  # (R, T-1)


class SharedState(NamedTuple):
    """The shared map and grid (replicated over a mesh's ranks), and each of
    this process's robots' tracking state."""

    map_xy: torch.Tensor      # (CAP, 2) f32
    map_valid: torch.Tensor   # (CAP,) bool
    occ: torch.Tensor         # (H, W) f32
    pose: torch.Tensor        # (R, 3)
    prev_pose: torch.Tensor   # (R, 3)
    prev_xy: torch.Tensor     # (R, N, 2) the robot's last accepted scan, global frame
    prev_valid: torch.Tensor  # (R, N) bool


def merge_occupancy(base: torch.Tensor, per_robot: torch.Tensor, group=None) -> torch.Tensor:
    """Log-space simultaneous composition of every robot's grid update:
    ``base (H, W)`` and ``per_robot (R, H, W)``, each robot's grid updated
    alone from ``base``.  The log-ratios to ``base`` are summed over the
    robots (JAX's ``psum``), then over the ranks of ``group`` when one is
    given, so free-space decay composes exactly and endpoint reinforcement
    as the product of the robots' ratios; clipped into ``[P_EPS, 1]``
    before the log and after the exp, in float32."""
    log_base = torch.log(torch.clamp(base, P_EPS, 1.0))
    d = (torch.log(torch.clamp(per_robot, P_EPS, 1.0)) - log_base).sum(0)
    if group is not None:
        all_sum_(d, group)
    return torch.clamp(torch.exp(log_base + d), P_EPS, 1.0)


def _candidates(xy: torch.Tensor, valid: torch.Tensor, group):
    """Insert candidates ``(N, 2)``, ``(N,)`` of this process's robots, in
    robot order, then over the ranks of ``group`` in rank order (one
    gather, the flags riding as a third column)."""
    if group is None:
        return xy, valid
    both = all_concat(torch.cat([xy, valid[:, None].to(xy.dtype)], dim=1), group)
    return both[:, :2], both[:, 2] > 0


def _robot_grids(occ: torch.Tensor, r: int) -> torch.Tensor:
    """``R`` copies of the shared grid for K4 to update in place: a new
    buffer, so no robot's update can reach the shared grid."""
    return occ.expand(r, *occ.shape).clone()


def shared_init(first_scans: torch.Tensor, cfg: SlamConfig, mesh=None) -> SharedState:
    """Seed the shared state from every robot's first scan ``(R, n_max, 3)``
    (with a ``mesh``, this rank's block of them): the gated points of all of
    them, in robot order, compacted into the map; the grid is the merge of
    each robot's update of a fresh grid from the origin; every pose is the
    identity and no previous scan is held."""
    group = None if mesh is None else mesh.get_group("data")
    r = first_scans.shape[0]
    dev = first_scans.device
    xy0, valid0 = geo.polar_to_cartesian(first_scans, cfg.gate)
    map_xy, map_valid = compact(*_candidates(xy0.reshape(-1, 2), valid0.reshape(-1), group), cfg.map_capacity)
    occ0 = torch.full((cfg.map.height_px, cfg.map.width_px), 0.5, dtype=torch.float32, device=dev)
    zeros = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    occ_r = update_occupancy(_robot_grids(occ0, r), xy0, valid0, zeros[:, :2], cfg.map, cfg.occupancy,
                             in_place=True)
    return SharedState(map_xy=map_xy, map_valid=map_valid, occ=merge_occupancy(occ0, occ_r, group),
                       pose=zeros, prev_pose=zeros.clone(), prev_xy=torch.zeros_like(xy0),
                       prev_valid=torch.zeros_like(valid0))


def make_shared_step(cfg: SlamConfig = SlamConfig(), mesh=None):
    """Build ``step(state, scans (R, n_max, 3), tick) -> (state, (pose (R,
    3), rmse (R,), accepted (R,)))``; ``tick`` is the host step index from 0
    (the maintenance runs when ``(tick + 1) % MAP_MAINTENANCE_INTERVAL ==
    0``).  With a ``mesh``, ``state`` and ``scans`` hold this rank's block
    of the robots and every rank calls the step with the same ``tick``.
    ``state`` is not modified."""
    check_supported_config(cfg)
    r2 = float(np.float32(cfg.local_map_radius_mm) ** 2)  # the f32 square, a host scalar
    group = None if mesh is None else mesh.get_group("data")
    ranks = 1 if group is None else torch.distributed.get_world_size(group)

    def step(state: SharedState, scans: torch.Tensor, tick: int):
        with span("slam.step", scans.device):
            return body(state, scans, tick)

    def body(state: SharedState, scans: torch.Tensor, tick: int):
        r = scans.shape[0]
        pose, prev_xy, prev_valid = state.pose, state.prev_xy, state.prev_valid
        with span("slam.gate"):
            xy, valid = geo.polar_to_cartesian(scans, cfg.gate)
        if cfg.use_outlier_filter:
            with span("slam.outlier"):
                valid = statistical_outlier_mask(xy, valid, cfg.outlier_nb_neighbors, cfg.outlier_std_ratio)

        with span("slam.target"):
            # every robot registers against the whole shared map, masked to its radius
            d2 = ((state.map_xy[None] - pose[:, None, :2]) ** 2).sum(-1)
            local = state.map_valid[None] & (d2 < r2)
            use_local = local.sum(-1, keepdim=True) >= cfg.min_local_map_points
            tgt_valid = torch.where(use_local, local, state.map_valid[None]).contiguous()
            tgt_xy = state.map_xy.expand(r, *state.map_xy.shape).contiguous()

        with span("slam.register"):
            enough = valid.sum(-1) >= cfg.icp.min_points
            ds_xy, ds_valid = voxel_downsample(xy, valid, cfg.icp.voxel_size_mm)
            init_pose = geo.se2_extrapolate(pose, state.prev_pose) if cfg.motion_model else pose
            res = icp_masked(ds_xy, ds_valid, tgt_xy, tgt_valid, init_pose, cfg.icp)
            accepted = enough & (res.rmse <= cfg.icp.max_rmse)
            if cfg.icp.rescue_estimator and not bool(accepted.all()):  # the step's one host read
                second = icp_masked(ds_xy, ds_valid, tgt_xy, tgt_valid, init_pose, _rescue_icp_cfg(cfg))
                res = _where(accepted, res, RegistrationResult(*(y.to(x.dtype) for x, y in zip(res, second))))
                accepted = enough & (res.rmse <= cfg.icp.max_rmse)

        with span("slam.update"):
            new_pose = torch.where(accepted[:, None], res.pose, pose)
            new_global = geo.se2_apply(res.pose, xy)
            cur_xy = torch.where(accepted[:, None, None], new_global, prev_xy)
            cur_valid = torch.where(accepted[:, None], valid, prev_valid)

            with span("slam.filter"):
                # insert candidates, filtered against the shared state before the update
                dd_xy, dd_valid = voxel_downsample(new_global, valid, cfg.duplicate_voxel_mm)
                add_valid = dynamic_points_mask(dd_xy, dd_valid, prev_xy, prev_valid, cfg.dynamic_distance_mm)
                add_valid = occupancy_keep_mask(dd_xy, add_valid, state.occ.expand(r, *state.occ.shape), cfg.map,
                                                cfg.occupancy.free_threshold)
                add_valid = add_valid & (accepted & enough)[:, None]
                occ_xy, occ_valid = voxel_downsample(cur_xy, cur_valid, 2.0 * cfg.map.resolution_mm_per_px)

            with span("slam.occupancy"):
                # each robot's occupancy update of its own copy of the shared grid, merged
                occ_r = update_occupancy(_robot_grids(state.occ, r), occ_xy, occ_valid & enough[:, None],
                                         new_pose[:, :2], cfg.map, cfg.occupancy, in_place=True)
                new_occ = merge_occupancy(state.occ, occ_r, group)
            new_pose = torch.where(enough[:, None], new_pose, pose)

            cand_xy, cand_valid = _candidates(dd_xy.reshape(-1, 2), add_valid.reshape(-1), group)
            big_xy = torch.cat([state.map_xy, cand_xy])
            big_valid = torch.cat([state.map_valid, cand_valid])
            if (tick + 1) % MAP_MAINTENANCE_INTERVAL == 0:
                with span("slam.maintain"):
                    # the prune's window is anchored at the fleet's mean position
                    anchor = new_pose[:, :2].sum(0)
                    if group is not None:
                        all_sum_(anchor, group)
                    anchor = anchor / (r * ranks)
                    pruned = prune_keep_mask(big_xy, big_valid, new_occ, anchor, cfg.map, cfg.occupancy)
                    ds2_xy, ds2_valid = voxel_downsample(big_xy, pruned, cfg.map_downsample_voxel_mm)
                    over = pruned.sum() > cfg.map_downsample_trigger
                    big_xy = torch.where(over, ds2_xy, big_xy)
                    big_valid = torch.where(over, ds2_valid, pruned)
            with span("slam.compact"):
                map_xy, map_valid = compact(big_xy, big_valid, cfg.map_capacity)
            new_state = SharedState(map_xy=map_xy, map_valid=map_valid, occ=new_occ, pose=new_pose,
                                    prev_pose=pose, prev_xy=cur_xy, prev_valid=cur_valid)
        return new_state, (new_pose, res.rmse, accepted)

    return step


def shared_fleet_run(scans, cfg: SlamConfig = SlamConfig(), device=None, mesh=None):
    """Replay ``(R, T, n_max, 3)`` scan stacks for R robots building ONE map
    on ``device`` (``None`` means the card).  Scan 0 of every stream seeds
    the shared map (all first scans are taken at one pose, the identity);
    scans 1..T-1 run through the shared step.

    With a ``mesh``, every rank is given the whole stack and runs its block
    of the robots (`mesh.rank_block`: R must divide by the ranks of the
    ``data`` axis) on its device (``device``: default the mesh's device on
    this rank), merging with the other ranks each step.

    Returns ``(map_xy (CAP, 2), map_valid (CAP,), occ (H, W), poses (R, 3),
    SharedOutputs)``, as JAX's ``shared_fleet_run`` does; over a mesh the
    map and the grid are the replicated ones and the poses and outputs are
    those of the rank's robots.
    """
    if mesh is not None:
        scans = scans[rank_block(scans.shape[0], mesh)]
        device = device or mesh_device(mesh)
    dev = resolve_device(device)
    if not isinstance(scans, torch.Tensor):
        scans = torch.from_numpy(np.ascontiguousarray(scans, dtype=np.float32))
    scans = scans.to(device=dev, dtype=torch.float32)
    if scans.dim() != 4 or scans.shape[1] < 2:
        raise ValueError(f"shared_fleet_run takes (R, T >= 2, n_max, 3) scans, not {tuple(scans.shape)}")
    check_supported_config(cfg, dev)
    step = make_shared_step(cfg, mesh)
    state = shared_init(scans[:, 0], cfg, mesh)
    outs = []
    for t in range(1, scans.shape[1]):
        state, out = step(state, scans[:, t], t - 1)
        outs.append(out)
    pose, rmse, acc = (torch.stack(f, dim=1) for f in zip(*outs))
    return state.map_xy, state.map_valid, state.occ, state.pose, SharedOutputs(pose, rmse, acc)
