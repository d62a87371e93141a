"""The SLAM odometry pipeline: one scan -> pose -> map step on fixed shapes,
written once over a robot axis.

Counterpart of the JAX package's ``slam/pipeline.py``.  Per scan (offline
semantics, the reference's `slam_offline.py:344-428`): gate -> optional
statistical outlier filter -> local-map mask -> voxel-downsample the scan ->
ICP (K1) -> RMSE gate -> on accept: transform to global -> dynamic-point
filter (K3) -> occupancy free-space filter -> occupancy update (K2 or K4)
-> insert -> downsample the map when over the trigger -> prune -> compact.  A
rejected scan changes nothing but ``step`` and ``prev_pose``.  Realtime
semantics (``cfg.realtime_semantics``, `mainn.py:316-361`) keep the pose on
reject but still update the occupancy grid, and prune and downsample the map
every `MAP_MAINTENANCE_INTERVAL` processed scans.

The robot axis.  `make_batched_step` builds the step for ``B`` robots: every
state field, scan and output carries a leading ``B``, every op and kernel
takes it, and a fleet step launches each kernel once, not once per robot.
`make_step` is the ``B = 1`` view of the same function.

Selects, not branches.  Where JAX branches with ``lax.cond``, the step
computes the update and keeps it per robot with ``torch.where`` over the
state fields, so a replay enqueues every scan without one host
synchronisation.  Two exceptions:
  * the occupancy grid: K2/K4 read the per-robot commit flag on the device,
    so the grid needs no select.  Who owns the grid picks the kernel
    (`ops/raster.update_occupancy`).  The fleet step (`make_batched_step`)
    owns the state it is given: K4 writes the windows into that state's grid
    buffer, the one state field updated IN PLACE, and the returned state
    carries the same tensor, so a fleet state must not be used again after
    it was stepped.  The single-robot step (`make_step`, and with it `Slam`)
    and `update_map` stay functional: K2 returns a new grid and every tensor
    a caller kept from an earlier state keeps its values.
  * the rescue (``cfg.icp.rescue_estimator``): a select would run the second
    registration (50 GICP iterations, each with a k-NN over the whole map) on
    every scan, so the step reads the accept flags on the host ONCE per scan
    and runs the rescue only when some robot rejected.  Configurations
    without a rescue (the ``fleet`` preset among them) make no host read.
The maintenance cadence is a host ``if`` when the caller passes ``tick`` (a
host integer, the sequence index) and a per-robot select on ``maint_count``
when it does not.

Stage spans (`utils/profiling.span`, free while no profiler collects): every
line of the step lies under one of ``slam.gate``, ``slam.outlier``,
``slam.target`` (the local-map crop), ``slam.register`` (downsample, motion
model, ICP, rescue, accept test) and ``slam.update``, whose children are
``slam.filter`` (dedup, dynamic and free-space filters), ``slam.occupancy``,
``slam.maintain`` (prune and downsample, on the cadence) and
``slam.compact``.  The fleet step (`parallel/fleet.py`) opens the root,
``slam.step``, around them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from icp_slam_yolo_tpu_torch.config import MAP_MAINTENANCE_INTERVAL, SlamConfig
from icp_slam_yolo_tpu_torch.core.registration import RegistrationResult, check_supported, icp_masked
from icp_slam_yolo_tpu_torch.device import resolve_device
from icp_slam_yolo_tpu_torch.ops import geometry as geo
from icp_slam_yolo_tpu_torch.ops.outliers import dynamic_points_mask, statistical_outlier_mask
from icp_slam_yolo_tpu_torch.ops.pallas import knn_kernel
from icp_slam_yolo_tpu_torch.ops.raster import occupancy_keep_mask, prune_keep_mask, update_occupancy
from icp_slam_yolo_tpu_torch.ops.voxel import compact, voxel_downsample, voxel_downsample_batched
from icp_slam_yolo_tpu_torch.utils.profiling import span


class SlamState(NamedTuple):
    """One robot's state, or a fleet's with a leading robot axis on every field."""

    pose: torch.Tensor         # (3,) f32 SE(2) global pose
    prev_pose: torch.Tensor    # (3,) pose before the last processed scan
    map_xy: torch.Tensor       # (CAP, 2) f32 global map points (mm)
    map_valid: torch.Tensor    # (CAP,) bool
    occ: torch.Tensor          # (H, W) f32 occupancy probabilities
    prev_xy: torch.Tensor      # (N, 2) previous accepted scan, global frame
    prev_valid: torch.Tensor   # (N,) bool
    step: torch.Tensor         # int32 scan counter (every scan)
    maint_count: torch.Tensor  # int32 processed-scan counter
    reject_run: torch.Tensor   # int32 consecutive-reject counter


class StepOutput(NamedTuple):
    pose: torch.Tensor      # (3,)
    rmse: torch.Tensor      # f32
    accepted: torch.Tensor  # bool
    n_points: torch.Tensor  # gated point count
    n_iters: torch.Tensor   # ICP iterations executed (the rescue's, where it ran)


def _rescue_icp_cfg(cfg: SlamConfig):
    return dataclasses.replace(cfg.icp, estimator=cfg.icp.rescue_estimator, rescue_estimator="", backend="xla")


def check_supported_config(cfg: SlamConfig, device=None) -> None:
    """Raise for a registration setting the port does not have and, given
    the ``device`` the steps will run on, for an outlier filter its kernel
    (K9) cannot take there."""
    check_supported(cfg.icp)
    if cfg.icp.rescue_estimator:
        check_supported(_rescue_icp_cfg(cfg))
    if device is not None and cfg.use_outlier_filter:
        knn_kernel.check_supported(cfg.outlier_nb_neighbors, cfg.n_max, device)


def _lift(t):
    """One robot's tuple -> the same tuple with a leading robot axis of 1 (views)."""
    return type(t)(*(x[None] for x in t))


def _drop(t):
    return type(t)(*(x[0] for x in t))


def _per_robot(pred: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``pred (B,)`` shaped to broadcast against ``like (B, ...)``."""
    return pred.reshape(-1, *([1] * (like.dim() - 1)))


def _where(pred: torch.Tensor, a, b):
    """Field-wise per-robot ``torch.where(pred, a, b)`` over two tuples."""
    return type(a)(*(torch.where(_per_robot(pred, x), x, y) for x, y in zip(a, b)))


def select_state(pred: torch.Tensor, a: SlamState, b: SlamState) -> SlamState:
    """Per-robot `_where` over the state (the port's ``lax.cond``), except
    the grid, taken from ``a``: ``a.occ`` was updated under ``pred``."""
    return SlamState(*(x if f == "occ" else torch.where(_per_robot(pred, x), x, y)
                       for f, x, y in zip(SlamState._fields, a, b)))


def _seed_map(xy: torch.Tensor, valid: torch.Tensor, cap: int):
    b, n = valid.shape
    m = min(n, cap)
    map_xy = torch.zeros((b, cap, 2), dtype=torch.float32, device=xy.device)
    map_valid = torch.zeros((b, cap), dtype=torch.bool, device=xy.device)
    map_xy[:, :m] = xy[:, :m]
    map_valid[:, :m] = valid[:, :m]
    return map_xy, map_valid


def _fresh_grid(b: int, cfg: SlamConfig, device) -> torch.Tensor:
    return torch.full((b, cfg.map.height_px, cfg.map.width_px), 0.5, dtype=torch.float32, device=device)


def init_fleet_state(first_scans: torch.Tensor, cfg: SlamConfig = SlamConfig(), *,
                     in_place: bool = True) -> SlamState:
    """Seed ``B`` robots from their first scans ``(B, n_max, 3)``: map <-
    gated points, occupancy update from the identity pose (``in_place``: of
    the fresh grids through K4, as the fleet step's; else through K2)."""
    dev = first_scans.device
    b = first_scans.shape[0]
    xy, valid = geo.polar_to_cartesian(first_scans, cfg.gate)
    map_xy, map_valid = _seed_map(xy, valid, cfg.map_capacity)
    zeros = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    occ = update_occupancy(_fresh_grid(b, cfg, dev), xy, valid, zeros[:, :2], cfg.map, cfg.occupancy,
                           in_place=in_place)
    count = torch.zeros(b, dtype=torch.int32, device=dev)
    return SlamState(
        pose=zeros, prev_pose=zeros.clone(), map_xy=map_xy, map_valid=map_valid, occ=occ,
        prev_xy=torch.zeros_like(xy), prev_valid=torch.zeros_like(valid),
        step=count, maint_count=count.clone(), reject_run=count.clone(),
    )


def init_state(first_scan: torch.Tensor, cfg: SlamConfig = SlamConfig()) -> SlamState:
    """Seed one robot's state from its first scan ``(n_max, 3)``."""
    return _drop(init_fleet_state(first_scan[None], cfg, in_place=False))


def _reseed_state(state: SlamState, xy, valid, cfg: SlamConfig, in_place: bool) -> SlamState:
    """Recovery reseed (``cfg.reseed_after_rejects``): rebuild map and
    occupancy from the current gated scan at the held pose, as
    `init_fleet_state` does, mid-sequence (the grid is a fresh one)."""
    cur = geo.se2_apply(state.pose, xy)
    map_xy, map_valid = _seed_map(cur, valid, cfg.map_capacity)
    occ = update_occupancy(_fresh_grid(valid.shape[0], cfg, xy.device), cur, valid, state.pose[:, :2],
                           cfg.map, cfg.occupancy, in_place=in_place)
    return state._replace(map_xy=map_xy, map_valid=map_valid, occ=occ, prev_xy=cur, prev_valid=valid)


def make_batched_step(cfg: SlamConfig = SlamConfig(), *, in_place: bool = True):
    """Build ``step(state, scans (B, n_max, 3), tick=None) -> (state,
    StepOutput)`` for ``B`` robots (see the module docstring).

    ``in_place`` (the fleet's default): the step owns ``state`` and K4 updates
    its grid in place; ``False`` leaves ``state`` untouched (K2, new grids).

    ``tick`` drives the realtime maintenance cadence from a robot-uniform
    host integer (fleets pass the sequence index): maintenance is then a host
    branch, free of any synchronisation, taken when ``(tick + 1) %
    MAP_MAINTENANCE_INTERVAL == 0``.  ``None`` keeps the reference's
    per-robot processed-scan count on the device with select semantics:
    every step pays the prune and the downsample.  The two coincide whenever
    no scan is skipped for lack of points.
    """
    check_supported_config(cfg)
    r2 = float(np.float32(cfg.local_map_radius_mm) ** 2)  # f32 square; a host scalar, no copy

    def downsample_over_trigger(big_xy, big_valid):
        ds_xy, ds_valid = voxel_downsample(big_xy, big_valid, cfg.map_downsample_voxel_mm)
        over = big_valid.sum(-1) > cfg.map_downsample_trigger
        return (torch.where(over[:, None, None], ds_xy, big_xy),
                torch.where(over[:, None], ds_valid, big_valid))

    def insert(state: SlamState, pose: torch.Tensor, xy, valid, accepted) -> SlamState:
        """The accepted-scan update of the map and the occupancy grid (a
        robot's window is committed only where ``accepted``)."""
        cur_xy = geo.se2_apply(pose, xy)
        with span("slam.filter"):
            if cfg.use_duplicate_filter:
                cur_dd, valid_dd = voxel_downsample(cur_xy, valid, cfg.duplicate_voxel_mm)
            else:
                cur_dd, valid_dd = cur_xy, valid
            add_valid = dynamic_points_mask(cur_dd, valid_dd, state.prev_xy, state.prev_valid,
                                            cfg.dynamic_distance_mm)
            add_valid = occupancy_keep_mask(cur_dd, add_valid, state.occ, cfg.map,
                                            cfg.occupancy.free_threshold)
        with span("slam.occupancy"):
            occ = update_occupancy(state.occ, cur_xy, valid, pose[:, :2], cfg.map, cfg.occupancy, accepted,
                                   in_place=in_place)
        with span("slam.maintain"):  # every step in these semantics
            big_xy, big_valid = downsample_over_trigger(torch.cat([state.map_xy, cur_dd], dim=1),
                                                        torch.cat([state.map_valid, add_valid], dim=1))
            big_valid = prune_keep_mask(big_xy, big_valid, occ, pose[:, :2], cfg.map, cfg.occupancy)
        with span("slam.compact"):
            map_xy, map_valid = compact(big_xy, big_valid, cfg.map_capacity)
        return SlamState(
            pose=pose, prev_pose=state.pose, map_xy=map_xy, map_valid=map_valid, occ=occ,
            prev_xy=cur_xy, prev_valid=valid, step=state.step + 1,
            maint_count=state.maint_count + 1, reject_run=state.reject_run,
        )

    def realtime_update(state: SlamState, xy, valid, res, accepted, enough, tick) -> SlamState:
        """Realtime-mode update.  On accept: pose <- T and the deduplicated,
        dynamic- and occupancy-filtered points are inserted.  On reject the
        pose and the occupancy scan stay the previous scan's global points.
        Either way the grid is updated (committed where ``enough``) with the
        points deduplicated at twice the grid resolution, and on the
        maintenance cadence the map is pruned and downsampled."""
        pose = torch.where(accepted[:, None], res.pose, state.pose)
        new_global = geo.se2_apply(res.pose, xy)
        cur_xy = torch.where(accepted[:, None, None], new_global, state.prev_xy)
        cur_valid = torch.where(accepted[:, None], valid, state.prev_valid)
        with span("slam.filter"):
            # duplicate filter and occupancy dedup as one two-row downsample
            (dd_xy, occ_xy), (dd_valid, occ_valid) = voxel_downsample_batched(
                torch.stack([new_global, cur_xy]), torch.stack([valid, cur_valid]),
                (cfg.duplicate_voxel_mm, 2.0 * cfg.map.resolution_mm_per_px),
            )
            add_valid = dynamic_points_mask(dd_xy, dd_valid, state.prev_xy, state.prev_valid,
                                            cfg.dynamic_distance_mm)
            add_valid = occupancy_keep_mask(dd_xy, add_valid, state.occ, cfg.map, cfg.occupancy.free_threshold)
        big_xy = torch.cat([state.map_xy, dd_xy], dim=1)
        big_valid = torch.cat([state.map_valid, add_valid & accepted[:, None]], dim=1)
        with span("slam.occupancy"):
            occ = update_occupancy(state.occ, occ_xy, occ_valid, pose[:, :2], cfg.map, cfg.occupancy, enough,
                                   in_place=in_place)

        def maintain():
            pruned = prune_keep_mask(big_xy, big_valid, occ, pose[:, :2], cfg.map, cfg.occupancy)
            return downsample_over_trigger(big_xy, pruned)

        new_maint = state.maint_count + 1
        if tick is None:
            with span("slam.maintain"):
                do_maint = (new_maint % MAP_MAINTENANCE_INTERVAL) == 0
                m_xy, m_valid = maintain()
                big_xy = torch.where(do_maint[:, None, None], m_xy, big_xy)
                big_valid = torch.where(do_maint[:, None], m_valid, big_valid)
        elif (int(tick) + 1) % MAP_MAINTENANCE_INTERVAL == 0:
            with span("slam.maintain"):
                big_xy, big_valid = maintain()
        with span("slam.compact"):
            map_xy, map_valid = compact(big_xy, big_valid, cfg.map_capacity)
        return SlamState(
            pose=pose, prev_pose=state.pose, map_xy=map_xy, map_valid=map_valid, occ=occ,
            prev_xy=cur_xy, prev_valid=cur_valid, step=state.step + 1,
            maint_count=new_maint, reject_run=state.reject_run,
        )

    def step(state: SlamState, scans: torch.Tensor, tick: int | None = None):
        dev = scans.device
        with span("slam.gate", dev):
            xy, valid = geo.polar_to_cartesian(scans, cfg.gate)
        if cfg.use_outlier_filter:
            with span("slam.outlier", dev):
                valid = statistical_outlier_mask(xy, valid, cfg.outlier_nb_neighbors, cfg.outlier_std_ratio)

        with span("slam.target", dev):
            # local-map mask: radius crop, full map when too few points survive
            d2 = ((state.map_xy - state.pose[:, None, :2]) ** 2).sum(-1)
            local = state.map_valid & (d2 < r2)
            use_local = local.sum(-1, keepdim=True) >= cfg.min_local_map_points
            tgt_valid = torch.where(use_local, local, state.map_valid)
            if cfg.local_map_capacity < cfg.map_capacity:
                tgt_xy, tgt_valid = compact(state.map_xy, tgt_valid, cfg.local_map_capacity)
            else:
                tgt_xy = state.map_xy
            tgt_xy, tgt_valid = tgt_xy.contiguous(), tgt_valid.contiguous()

        with span("slam.register", dev):
            n_points = valid.sum(-1)
            enough = n_points >= cfg.icp.min_points
            ds_xy, ds_valid = voxel_downsample(xy, valid, cfg.icp.voxel_size_mm)
            init_pose = geo.se2_extrapolate(state.pose, state.prev_pose) if cfg.motion_model else state.pose
            res = icp_masked(ds_xy, ds_valid, tgt_xy, tgt_valid, init_pose, cfg.icp)
            accepted = enough & (res.rmse <= cfg.icp.max_rmse)
            # second chance for rejected scans: the step's one host read
            if cfg.icp.rescue_estimator and not bool(accepted.all()):
                second = icp_masked(ds_xy, ds_valid, tgt_xy, tgt_valid, init_pose, _rescue_icp_cfg(cfg))
                res = _where(accepted, res, RegistrationResult(*(y.to(x.dtype) for x, y in zip(res, second))))
                accepted = enough & (res.rmse <= cfg.icp.max_rmse)

        with span("slam.update", dev):
            if cfg.localization_only:
                pose = torch.where(accepted[:, None], res.pose, state.pose)
                new_state = state._replace(
                    pose=pose, prev_pose=state.pose,
                    prev_xy=torch.where(accepted[:, None, None], geo.se2_apply(pose, xy), state.prev_xy),
                    prev_valid=torch.where(accepted[:, None], valid, state.prev_valid),
                    step=state.step + 1,
                )
            elif cfg.realtime_semantics:
                new_state = select_state(enough, realtime_update(state, xy, valid, res, accepted, enough, tick),
                                         state._replace(step=state.step + 1))
            else:
                kept = state._replace(step=state.step + 1, prev_pose=state.pose)
                new_state = select_state(accepted, insert(state, res.pose, xy, valid, accepted), kept)

            if cfg.reseed_after_rejects > 0 and not cfg.localization_only:
                # as a select: the rebuilt map and grid are computed every step
                run = torch.where(accepted, torch.zeros_like(state.reject_run), state.reject_run + 1)
                need = ~accepted & enough & (run >= cfg.reseed_after_rejects)
                new_state = _where(need, _reseed_state(new_state, xy, valid, cfg, in_place), new_state)
                new_state = new_state._replace(reject_run=torch.where(need, torch.zeros_like(run), run))

            out = StepOutput(pose=new_state.pose, rmse=res.rmse, accepted=accepted,
                             n_points=n_points, n_iters=res.n_iters)
        return new_state, out

    return step


def make_step(cfg: SlamConfig = SlamConfig()):
    """Build ``step(state, scan_raw (n_max, 3), tick=None) -> (state,
    StepOutput)`` for one robot: the ``B = 1`` view of `make_batched_step`,
    functional (``state`` is left as it was)."""
    batched = make_batched_step(cfg, in_place=False)

    def step(state: SlamState, scan_raw: torch.Tensor, tick: int | None = None):
        new_state, out = batched(_lift(state), scan_raw[None], tick)
        return _drop(new_state), _drop(out)

    return step


def run_sequence(scans, cfg: SlamConfig = SlamConfig(), device=None):
    """Replay a padded scan stack ``(T, n_max, 3)``: scan 0 seeds the state,
    scans 1..T-1 run through the step on ``device`` (``None`` means the card).

    Returns ``(final_state, outputs)``; the ``outputs`` fields are stacked
    per-scan ``(T-1, ...)`` tensors.
    """
    dev = resolve_device(device)
    if not isinstance(scans, torch.Tensor):
        scans = torch.from_numpy(np.ascontiguousarray(scans, dtype=np.float32))
    scans = scans.to(device=dev, dtype=torch.float32)
    check_supported_config(cfg, dev)
    step = make_step(cfg)
    state = init_state(scans[0], cfg)
    outs = []
    for t in range(1, scans.shape[0]):
        state, out = step(state, scans[t])
        outs.append(out)
    if not outs:
        raise ValueError("run_sequence needs at least two scans")
    return state, StepOutput(*(torch.stack(f) for f in zip(*outs)))


def update_map(state: SlamState, scan_raw, pose, cfg: SlamConfig = SlamConfig()) -> SlamState:
    """Insert one gated scan into one robot's map and occupancy at a given
    pose, skipping registration (the ``update_map(scan, pose)`` API)."""
    dev = state.pose.device
    scan = torch.as_tensor(np.asarray(scan_raw, np.float32), device=dev)
    pose = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
    xy, valid = geo.polar_to_cartesian(scan, cfg.gate)
    cur_xy = geo.se2_apply(pose, xy)
    add_valid = occupancy_keep_mask(cur_xy, valid, state.occ, cfg.map, cfg.occupancy.free_threshold)
    big_xy = torch.cat([state.map_xy, cur_xy])
    big_valid = torch.cat([state.map_valid, add_valid])
    occ = update_occupancy(state.occ[None], cur_xy[None], valid[None], pose[None, :2], cfg.map, cfg.occupancy)[0]
    map_xy, map_valid = compact(big_xy, big_valid, cfg.map_capacity)
    return state._replace(pose=pose, map_xy=map_xy, map_valid=map_valid, occ=occ, step=state.step + 1)
