"""The SLAM odometry pipeline: one scan -> pose -> map step on fixed shapes.

Counterpart of the JAX package's ``slam/pipeline.py`` with the offline
semantics of the reference (`slam_offline.py:344-428`).  Per scan:
gate -> local-map mask -> voxel-downsample the scan -> ICP (K1) -> RMSE gate
-> on accept: transform to global -> dynamic-point filter (K3) -> occupancy
free-space filter -> insert -> downsample the map when over the trigger ->
occupancy update (K2) -> prune -> compact.  A rejected scan changes nothing
but ``step`` and ``prev_pose``.

Where JAX branches with ``lax.cond``, the step computes the update and keeps
it with ``torch.where`` over the state fields, so a replay enqueues every
scan without one host synchronisation.  The occupancy grid is the exception:
K2 reads the accept flag on the device and commits its window only on
accept, so the grid needs no select.

Not ported yet (they raise, naming the ROADMAP.md item): the GICP rescue
(``icp.rescue_estimator``), realtime semantics, the statistical outlier
filter and the reseed after rejects.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_slam_yolo_tpu_torch.config import SlamConfig
from icp_slam_yolo_tpu_torch.core.registration import check_supported, icp_masked
from icp_slam_yolo_tpu_torch.device import resolve_device
from icp_slam_yolo_tpu_torch.ops import geometry as geo
from icp_slam_yolo_tpu_torch.ops.outliers import dynamic_points_mask
from icp_slam_yolo_tpu_torch.ops.raster import occupancy_keep_mask, prune_keep_mask, update_occupancy
from icp_slam_yolo_tpu_torch.ops.voxel import compact, voxel_downsample

_NEXT_SLICE = "ROADMAP.md 'Open items' 1, item 2 (GICP rescue and realtime preset)"


class SlamState(NamedTuple):
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
    n_iters: torch.Tensor   # ICP iterations executed


def check_supported_config(cfg: SlamConfig) -> None:
    """Raise for the configuration features this slice does not port."""
    if cfg.icp.rescue_estimator:
        raise NotImplementedError(
            f"icp.rescue_estimator={cfg.icp.rescue_estimator!r} waits for {_NEXT_SLICE}; "
            "use icp.rescue_estimator=''"
        )
    for name in ("realtime_semantics", "use_outlier_filter"):
        if getattr(cfg, name):
            raise NotImplementedError(f"{name}=True waits for {_NEXT_SLICE}")
    if cfg.reseed_after_rejects > 0:
        raise NotImplementedError(f"reseed_after_rejects > 0 waits for {_NEXT_SLICE}")
    check_supported(cfg.icp)


def _i32(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def init_state(first_scan: torch.Tensor, cfg: SlamConfig = SlamConfig()) -> SlamState:
    """Seed the state from the first scan: map <- gated points, occupancy
    update from the identity pose."""
    dev = first_scan.device
    xy, valid = geo.polar_to_cartesian(first_scan, cfg.gate)
    cap = cfg.map_capacity
    m = min(xy.shape[0], cap)
    map_xy = torch.zeros((cap, 2), dtype=torch.float32, device=dev)
    map_valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    map_xy[:m] = xy[:m]
    map_valid[:m] = valid[:m]
    occ = torch.full((cfg.map.height_px, cfg.map.width_px), 0.5, dtype=torch.float32, device=dev)
    occ = update_occupancy(occ, xy, valid, torch.zeros(2, dtype=torch.float32, device=dev),
                           cfg.map, cfg.occupancy)
    return SlamState(
        pose=geo.se2_identity(dev), prev_pose=geo.se2_identity(dev),
        map_xy=map_xy, map_valid=map_valid, occ=occ,
        prev_xy=torch.zeros_like(xy), prev_valid=torch.zeros_like(valid),
        step=_i32(0, dev), maint_count=_i32(0, dev), reject_run=_i32(0, dev),
    )


def select_state(pred: torch.Tensor, a: SlamState, b: SlamState) -> SlamState:
    """Field-wise ``torch.where(pred, a, b)`` (the port's ``lax.cond``),
    except the grid, taken from ``a``: ``a.occ`` was updated under ``pred``."""
    return SlamState(*(x if f == "occ" else torch.where(pred, x, y)
                       for f, x, y in zip(SlamState._fields, a, b)))


def make_step(cfg: SlamConfig = SlamConfig()):
    """Build ``step(state, scan_raw (n_max, 3)) -> (state, StepOutput)``."""
    check_supported_config(cfg)

    def insert(state: SlamState, pose: torch.Tensor, xy, valid, accepted) -> SlamState:
        """The accepted-scan update of the map and the occupancy grid (the
        grid's window is committed only where ``accepted``)."""
        cur_xy = geo.se2_apply(pose, xy)
        if cfg.use_duplicate_filter:
            cur_dd, valid_dd = voxel_downsample(cur_xy, valid, cfg.duplicate_voxel_mm)
        else:
            cur_dd, valid_dd = cur_xy, valid
        add_valid = dynamic_points_mask(cur_dd, valid_dd, state.prev_xy, state.prev_valid,
                                        cfg.dynamic_distance_mm)
        add_valid = occupancy_keep_mask(cur_dd, add_valid, state.occ, cfg.map,
                                        cfg.occupancy.free_threshold)
        big_xy = torch.cat([state.map_xy, cur_dd])
        big_valid = torch.cat([state.map_valid, add_valid])
        ds_xy, ds_valid = voxel_downsample(big_xy, big_valid, cfg.map_downsample_voxel_mm)
        over = big_valid.sum() > cfg.map_downsample_trigger
        big_xy = torch.where(over, ds_xy, big_xy)
        big_valid = torch.where(over, ds_valid, big_valid)
        occ = update_occupancy(state.occ, cur_xy, valid, pose[:2], cfg.map, cfg.occupancy, accepted)
        big_valid = prune_keep_mask(big_xy, big_valid, occ, pose[:2], cfg.map, cfg.occupancy)
        map_xy, map_valid = compact(big_xy, big_valid, cfg.map_capacity)
        return SlamState(
            pose=pose, prev_pose=state.pose, map_xy=map_xy, map_valid=map_valid, occ=occ,
            prev_xy=cur_xy, prev_valid=valid, step=state.step + 1,
            maint_count=state.maint_count + 1, reject_run=state.reject_run,
        )

    def step(state: SlamState, scan_raw: torch.Tensor):
        xy, valid = geo.polar_to_cartesian(scan_raw, cfg.gate)
        n_points = valid.sum()
        enough = n_points >= cfg.icp.min_points

        # local-map mask: radius crop, full map when too few points survive
        d2 = ((state.map_xy - state.pose[:2]) ** 2).sum(-1)
        r2 = float(np.float32(cfg.local_map_radius_mm) ** 2)  # f32 square; a host scalar, no copy
        local = state.map_valid & (d2 < r2)
        use_local = local.sum() >= cfg.min_local_map_points
        tgt_valid = torch.where(use_local, local, state.map_valid)
        if cfg.local_map_capacity < cfg.map_capacity:
            tgt_xy, tgt_valid = compact(state.map_xy, tgt_valid, cfg.local_map_capacity)
        else:
            tgt_xy = state.map_xy

        ds_xy, ds_valid = voxel_downsample(xy, valid, cfg.icp.voxel_size_mm)
        init_pose = geo.se2_extrapolate(state.pose, state.prev_pose) if cfg.motion_model else state.pose
        res = icp_masked(ds_xy, ds_valid, tgt_xy.contiguous(), tgt_valid.contiguous(),
                         init_pose, cfg.icp)
        accepted = enough & (res.rmse <= cfg.icp.max_rmse)

        if cfg.localization_only:
            pose = torch.where(accepted, res.pose, state.pose)
            new_state = state._replace(
                pose=pose, prev_pose=state.pose,
                prev_xy=torch.where(accepted, geo.se2_apply(pose, xy), state.prev_xy),
                prev_valid=torch.where(accepted, valid, state.prev_valid),
                step=state.step + 1,
            )
        else:
            kept = state._replace(step=state.step + 1, prev_pose=state.pose)
            new_state = select_state(accepted, insert(state, res.pose, xy, valid, accepted), kept)

        out = StepOutput(pose=new_state.pose, rmse=res.rmse, accepted=accepted,
                         n_points=n_points, n_iters=res.n_iters)
        return new_state, out

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
    """Insert one gated scan into the map and occupancy at a given pose,
    skipping registration (the ``update_map(scan, pose)`` API)."""
    dev = state.pose.device
    scan = torch.as_tensor(np.asarray(scan_raw, np.float32), device=dev)
    pose = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
    xy, valid = geo.polar_to_cartesian(scan, cfg.gate)
    cur_xy = geo.se2_apply(pose, xy)
    add_valid = occupancy_keep_mask(cur_xy, valid, state.occ, cfg.map, cfg.occupancy.free_threshold)
    big_xy = torch.cat([state.map_xy, cur_xy])
    big_valid = torch.cat([state.map_valid, add_valid])
    occ = update_occupancy(state.occ, cur_xy, valid, pose[:2], cfg.map, cfg.occupancy)
    map_xy, map_valid = compact(big_xy, big_valid, cfg.map_capacity)
    return state._replace(pose=pose, map_xy=map_xy, map_valid=map_valid, occ=occ, step=state.step + 1)
