"""Pure-NumPy oracle of the SLAM pipeline (float64, no torch).

The port's own copy of the JAX package's ``reference_impl/oracle.py``: the
same functions, the same operations in the same order, so the two give the
same bits (`tests/test_torch_oracle.py` holds them equal); only the config
import differs.  It is the "NumPy reference path" named in ``BASELINE.json``
and the single-threaded CPU baseline that `cli bench` measures against
(`bench.bench_baseline`); `io/scans.py` takes `polar_gate` and `se2_apply`
from it.  The CPU tests hold the port to the JAX package's copy, the
independent reference.

Algorithmic lineage (what each function replaces in the reference):
  * `icp` — `labels_segmentation/icp.py:28-53` + Open3D `registration_icp`
    correspondence gating (`gicp_lidar.py:29-35`).
  * `voxel_downsample` — Open3D `voxel_down_sample` (`gicp_lidar.py:8-11`).
  * `update_occupancy` — `process.py:114-179` with frozen-probability early
    stop.
  * `run_sequence` — `slam_offline.py:344-428` order of operations.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from icp_slam_yolo_tpu_torch.config import SlamConfig


# --- geometry ---------------------------------------------------------------

def polar_gate(scan: np.ndarray, gate) -> np.ndarray:
    """Gated cartesian points ``(M, 2)`` float64 (compacted — NumPy can)."""
    q, a, d = scan[:, 0], scan[:, 1], scan[:, 2]
    keep = (d > gate.min_dist_mm) & (d < gate.max_dist_mm) & (q > gate.min_quality)
    if gate.front_arc_only:
        keep &= (a <= gate.front_arc_lo_deg) | (a >= gate.front_arc_hi_deg)
    rad = np.deg2rad(a[keep])
    y_sign = getattr(gate, "y_sign", -1.0)
    return np.stack([d[keep] * np.cos(rad), y_sign * d[keep] * np.sin(rad)], axis=1)


def se2_apply(pose: np.ndarray, xy: np.ndarray) -> np.ndarray:
    c, s = np.cos(pose[2]), np.sin(pose[2])
    r = np.array([[c, -s], [s, c]])
    return xy @ r.T + pose[:2]


def se2_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    xy = se2_apply(a, b[None, :2])[0]
    return np.array([xy[0], xy[1], a[2] + b[2]])


# --- voxel grid ---------------------------------------------------------------

_OFF = 4096
_STRIDE = 2 * _OFF


def voxel_downsample(xy: np.ndarray, voxel: float) -> np.ndarray:
    """Origin-anchored segment-mean voxel downsample, key-sorted output —
    identical bucketing and ordering to ops/voxel.py."""
    if len(xy) == 0:
        return xy
    ij = np.clip(np.floor(xy / voxel).astype(np.int64) + _OFF, 0, _STRIDE - 1)
    key = ij[:, 0] * _STRIDE + ij[:, 1]
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros((len(uniq), 2))
    np.add.at(sums, inv, xy)
    cnts = np.bincount(inv, minlength=len(uniq))
    return sums / cnts[:, None]


# --- nearest neighbour / ICP --------------------------------------------------

def nn_bruteforce(src: np.ndarray, tgt: np.ndarray):
    d2 = ((src[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
    idx = np.argmin(d2, axis=1)
    return np.sqrt(d2[np.arange(len(src)), idx]), idx


def best_fit_se2(src: np.ndarray, dst: np.ndarray, w: np.ndarray):
    wsum = w.sum()
    if wsum < 1e-6:
        return 0.0, np.zeros(2)
    ca = (src * w[:, None]).sum(0) / wsum
    cb = (dst * w[:, None]).sum(0) / wsum
    a, b = src - ca, dst - cb
    sxx = (w * (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1])).sum()
    sxy = (w * (a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])).sum()
    theta = np.arctan2(sxy, sxx)
    c, s = np.cos(theta), np.sin(theta)
    r_ca = np.array([c * ca[0] - s * ca[1], s * ca[0] + c * ca[1]])
    return theta, cb - r_ca


def icp(src: np.ndarray, tgt: np.ndarray, init_pose: np.ndarray, cfg) -> tuple[np.ndarray, float]:
    """Gated point-to-point ICP; returns ``(pose, inlier_rmse)``."""
    if len(src) < cfg.min_points or len(tgt) < cfg.min_points:
        return init_pose.copy(), float("inf")
    pose = init_pose.astype(np.float64).copy()
    prev_err = 1e30
    for _ in range(cfg.max_iterations):
        moved = se2_apply(pose, src)
        dist, idx = nn_bruteforce(moved, tgt)
        w = (dist < cfg.threshold_mm).astype(np.float64)
        if cfg.huber_delta_mm > 0:
            w = w * np.minimum(1.0, cfg.huber_delta_mm / np.maximum(dist, 1e-6))
        dtheta, dt = best_fit_se2(moved, tgt[idx], w)
        pose = se2_compose(np.array([dt[0], dt[1], dtheta]), pose)
        err = dist[w > 0].mean() if (w > 0).any() else 1e30
        if abs(prev_err - err) < cfg.tolerance:
            break
        prev_err = err
    moved = se2_apply(pose, src)
    dist, _ = nn_bruteforce(moved, tgt)
    inl = dist < cfg.threshold_mm
    if not inl.any():
        return init_pose.copy(), float("inf")
    return pose, float(np.sqrt((dist[inl] ** 2).mean()))


# --- occupancy ----------------------------------------------------------------

def bresenham(x0: int, y0: int, x1: int, y1: int) -> list[tuple[int, int]]:
    """Integer Bresenham identical to `process.py:86-112` (incl. the dx>dy
    branch split and appended endpoint)."""
    pts = []
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    x, y = x0, y0
    sx = -1 if x0 > x1 else 1
    sy = -1 if y0 > y1 else 1
    if dx > dy:
        err = dx / 2.0
        while x != x1:
            pts.append((x, y))
            err -= dy
            if err < 0:
                y += sy
                err += dx
            x += sx
    else:
        err = dy / 2.0
        while y != y1:
            pts.append((x, y))
            err -= dx
            if err < 0:
                x += sx
                err += dy
            y += sy
    pts.append((x1, y1))
    return pts


def world_to_px(xy: np.ndarray, map_cfg):
    cx, cy = map_cfg.center_px
    res = map_cfg.resolution_mm_per_px
    px = np.trunc(cx + xy[..., 0] / res).astype(np.int64)
    py = np.trunc(cy - xy[..., 1] / res).astype(np.int64)
    return px, py


def update_occupancy(occ: np.ndarray, points: np.ndarray, robot_xy: np.ndarray, map_cfg, occ_cfg) -> np.ndarray:
    """Frozen-probability occupancy update (matches ops/raster.py semantics)."""
    h, w = occ.shape
    win = occ_cfg.window_px
    rx, ry = world_to_px(robot_xy[None], map_cfg)
    rx, ry = int(rx[0]), int(ry[0])
    x1, y1 = max(0, rx - win), max(0, ry - win)
    x2, y2 = min(w, rx + win), min(h, ry + win)

    p0 = occ.copy()
    free_n = np.zeros_like(occ)
    occ_n = np.zeros_like(occ)
    for pt in points:
        ex, ey = world_to_px(pt[None], map_cfg)
        ex, ey = int(ex[0]), int(ey[0])
        if not (x1 <= ex < x2 and y1 <= ey < y2):
            continue
        line = bresenham(rx, ry, ex, ey)
        cells = [c for c in line]
        blocked = False
        for i, (x, y) in enumerate(cells):
            if not (x1 <= x < x2 and y1 <= y < y2):
                continue
            if i == len(cells) - 1:
                if not blocked:
                    occ_n[y, x] += 1
            else:
                if p0[y, x] >= occ_cfg.block_threshold:
                    blocked = True
                if blocked:
                    break
                free_n[y, x] += 1
    p = occ * occ_cfg.p_free_decay ** free_n
    return np.minimum(1.0, p + occ_cfg.p_occ_inc * occ_n)


def occupancy_keep_mask(points: np.ndarray, occ: np.ndarray, map_cfg, free_threshold: float) -> np.ndarray:
    h, w = occ.shape
    px, py = world_to_px(points, map_cfg)
    oob = (px < 0) | (px >= w) | (py < 0) | (py >= h)
    pxc, pyc = np.clip(px, 0, w - 1), np.clip(py, 0, h - 1)
    return oob | (occ[pyc, pxc] >= free_threshold)


def prune_keep_mask(points: np.ndarray, occ: np.ndarray, robot_xy: np.ndarray, map_cfg, occ_cfg) -> np.ndarray:
    """Prune keep-mask mirroring `ops/raster.prune_keep_mask`: with
    ``prune_window_margin_px >= 0`` only points inside the margin-expanded
    raster window are re-checked (cells elsewhere cannot have changed since
    the previous prune); ``< 0`` is the exact full-grid check."""
    margin = occ_cfg.prune_window_margin_px
    if margin < 0:
        return occupancy_keep_mask(points, occ, map_cfg, occ_cfg.free_threshold)
    h, w = occ.shape
    win = occ_cfg.window_px + margin
    ww, wh = min(2 * win, w), min(2 * win, h)
    rx, ry = world_to_px(robot_xy[None, :], map_cfg)
    rx, ry = int(rx[0]), int(ry[0])
    x1s = np.clip(rx - win, 0, w - ww)
    y1s = np.clip(ry - win, 0, h - wh)
    px, py = world_to_px(points, map_cfg)
    inside = (px >= x1s) & (px < x1s + ww) & (py >= y1s) & (py < y1s + wh)
    keep = np.ones(len(points), bool)
    keep[inside] = occ[py[inside], px[inside]] >= occ_cfg.free_threshold
    return keep


# --- full pipeline --------------------------------------------------------------

@dataclasses.dataclass
class OracleState:
    pose: np.ndarray
    map_xy: np.ndarray
    occ: np.ndarray
    prev_xy: np.ndarray | None
    reject_run: int = 0  # consecutive rejects, drives cfg.reseed_after_rejects


def _maybe_reseed(state: OracleState, xy: np.ndarray, accepted: bool, cfg: SlamConfig) -> OracleState:
    """Recovery reseed mirror of `slam/pipeline._reseed_state`."""
    if accepted:
        state.reject_run = 0
        return state
    state.reject_run += 1
    r = cfg.reseed_after_rejects
    if r <= 0 or cfg.localization_only or state.reject_run < r or len(xy) < cfg.icp.min_points:
        return state
    cur = se2_apply(state.pose, xy)
    occ = np.full((cfg.map.height_px, cfg.map.width_px), 0.5)
    occ = update_occupancy(occ, cur, state.pose[:2], cfg.map, cfg.occupancy)
    return OracleState(pose=state.pose.copy(), map_xy=cur.copy(), occ=occ, prev_xy=cur, reject_run=0)


def init_state(first_scan: np.ndarray, cfg: SlamConfig) -> OracleState:
    xy = polar_gate(first_scan, cfg.gate)
    occ = np.full((cfg.map.height_px, cfg.map.width_px), 0.5)
    occ = update_occupancy(occ, xy, np.zeros(2), cfg.map, cfg.occupancy)
    return OracleState(pose=np.zeros(3), map_xy=xy.copy(), occ=occ, prev_xy=None)


def step(state: OracleState, scan: np.ndarray, cfg: SlamConfig):
    xy = polar_gate(scan, cfg.gate)
    n = len(xy)
    if n < cfg.icp.min_points:
        state.reject_run += 1  # counted, but too few points to reseed from
        return state, dict(pose=state.pose.copy(), rmse=float("inf"), accepted=False)

    d2 = ((state.map_xy - state.pose[:2]) ** 2).sum(-1)
    local = state.map_xy[d2 < cfg.local_map_radius_mm**2]
    tgt = local if len(local) >= cfg.min_local_map_points else state.map_xy

    src = voxel_downsample(xy, cfg.icp.voxel_size_mm)
    pose, rmse = icp(src, tgt, state.pose, cfg.icp)
    accepted = rmse <= cfg.icp.max_rmse
    if not accepted:
        state = _maybe_reseed(state, xy, False, cfg)
        return state, dict(pose=state.pose.copy(), rmse=rmse, accepted=False)
    state = _maybe_reseed(state, xy, True, cfg)

    cur = se2_apply(pose, xy)
    if state.prev_xy is not None and len(state.prev_xy) and len(cur):
        dist, _ = nn_bruteforce(cur, state.prev_xy)
        to_add = cur[dist < cfg.dynamic_distance_mm]
    else:
        to_add = cur
    keep = occupancy_keep_mask(to_add, state.occ, cfg.map, cfg.occupancy.free_threshold)
    to_add = to_add[keep]

    map_xy = np.concatenate([state.map_xy, to_add], axis=0)
    if len(map_xy) > cfg.map_downsample_trigger:
        map_xy = voxel_downsample(map_xy, cfg.map_downsample_voxel_mm)

    occ = update_occupancy(state.occ, cur, pose[:2], cfg.map, cfg.occupancy)
    map_xy = map_xy[prune_keep_mask(map_xy, occ, pose[:2], cfg.map, cfg.occupancy)]
    map_xy = map_xy[: cfg.map_capacity]

    new = OracleState(pose=pose, map_xy=map_xy, occ=occ, prev_xy=cur)
    return new, dict(pose=pose.copy(), rmse=rmse, accepted=True)


def run_sequence(scans, cfg: SlamConfig = SlamConfig()):
    """Replay raw (unpadded ok) scans; returns (state, poses, rmses, accepts)."""
    state = init_state(scans[0], cfg)
    poses, rmses, accepts = [], [], []
    for scan in scans[1:]:
        state, out = step(state, scan, cfg)
        poses.append(out["pose"])
        rmses.append(out["rmse"])
        accepts.append(out["accepted"])
    return state, np.array(poses), np.array(rmses), np.array(accepts)


# --- realtime semantics (`mainn.py:267-399`) -----------------------------------

def statistical_outlier_keep(xy: np.ndarray, nb_neighbors: int, std_ratio: float, pad_to: int) -> np.ndarray:
    """Keep-mask matching ops/outliers.statistical_outlier_mask: mean distance
    to the up-to-k nearest real neighbours, threshold mean + ratio * std."""
    n = len(xy)
    if n == 0:
        return np.zeros(0, bool)
    d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    take = min(nb_neighbors, n - 1)
    if take == 0:
        return np.ones(n, bool)
    dists = np.sqrt(np.sort(d2, axis=1))
    mean_knn = dists[:, :take].mean(axis=1)
    mu = mean_knn.mean()
    var = ((mean_knn - mu) ** 2).mean()
    return mean_knn <= mu + std_ratio * np.sqrt(var)


def step_realtime(state: OracleState, scan: np.ndarray, cfg: SlamConfig, counter: int):
    xy = polar_gate(scan, cfg.gate)
    if cfg.use_outlier_filter and len(xy):
        xy = xy[statistical_outlier_keep(xy, cfg.outlier_nb_neighbors, cfg.outlier_std_ratio, cfg.n_max)]
    if len(xy) < cfg.icp.min_points:
        state.reject_run += 1  # counted, but too few points to reseed from
        return state, dict(pose=state.pose.copy(), rmse=float("inf"), accepted=False), counter

    d2 = ((state.map_xy - state.pose[:2]) ** 2).sum(-1)
    local = state.map_xy[d2 < cfg.local_map_radius_mm**2]
    tgt = local if len(local) >= cfg.min_local_map_points else state.map_xy
    src = voxel_downsample(xy, cfg.icp.voxel_size_mm)
    pose, rmse = icp(src, tgt, state.pose, cfg.icp)
    accepted = rmse <= cfg.icp.max_rmse

    map_xy = state.map_xy
    if accepted:
        new_global = se2_apply(pose, xy)
        dd = voxel_downsample(new_global, cfg.duplicate_voxel_mm)
        if state.prev_xy is not None and len(state.prev_xy) and len(dd):
            dist, _ = nn_bruteforce(dd, state.prev_xy)
            dd = dd[dist < cfg.dynamic_distance_mm]
        dd = dd[occupancy_keep_mask(dd, state.occ, cfg.map, cfg.occupancy.free_threshold)]
        map_xy = np.concatenate([map_xy, dd], axis=0)
        cur = new_global
        new_pose = pose
    else:
        cur = state.prev_xy if state.prev_xy is not None else np.zeros((0, 2))
        new_pose = state.pose

    occ_pts = voxel_downsample(cur, 2.0 * cfg.map.resolution_mm_per_px) if len(cur) else cur
    occ = update_occupancy(state.occ, occ_pts, new_pose[:2], cfg.map, cfg.occupancy)

    counter += 1
    if counter % 10 == 0:
        map_xy = map_xy[prune_keep_mask(map_xy, occ, new_pose[:2], cfg.map, cfg.occupancy)]
        if len(map_xy) > cfg.map_downsample_trigger:
            map_xy = voxel_downsample(map_xy, cfg.map_downsample_voxel_mm)
    map_xy = map_xy[: cfg.map_capacity]

    new = OracleState(
        pose=new_pose.copy(), map_xy=map_xy, occ=occ, prev_xy=cur,
        reject_run=state.reject_run,
    )
    new = _maybe_reseed(new, xy, accepted, cfg)
    return new, dict(pose=new_pose.copy(), rmse=rmse, accepted=accepted), counter


def run_sequence_realtime(scans, cfg: SlamConfig):
    state = init_state(scans[0], cfg)
    poses, rmses, accepts = [], [], []
    counter = 0
    for scan in scans[1:]:
        state, out, counter = step_realtime(state, scan, cfg, counter)
        poses.append(out["pose"])
        rmses.append(out["rmse"])
        accepts.append(out["accepted"])
    return state, np.array(poses), np.array(rmses), np.array(accepts)
