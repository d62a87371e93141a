"""Plain reference of the realtime SLAM step over a robot axis, in float64.

Written from the configuration file and the semantics of the float64 NumPy
oracle the SLAM package is held to (gate, statistical outlier filter,
origin-anchored voxel means, gated point-to-point ICP with a closed-form
2-D Kabsch step, frozen-probability Bresenham occupancy update, map prune
and downsample), extended as the realtime fleet step runs: the constant-
velocity start of ICP, the duplicate filter and the occupancy dedup by
voxel, the per-robot select on "enough points", the maintenance on a
fleet-uniform tick, compaction into fixed capacities, and for robots
sharing one map the log-space merge of every robot's grid update.  It takes
the state before a step and the step's scans and returns what the step
should produce.

``Precision`` says how it computes: ``F64`` is the reference; ``TF32`` is
the check's control, float32 with the nearest-neighbour distances taken as
a Gram product of inputs rounded to TF32's 10-bit mantissa, which is what
a tensor-core distance would do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_OFF = 4096
_STRIDE = 2 * _OFF
_NO_KEY = _STRIDE * _STRIDE


class Precision(NamedTuple):
    dtype: torch.dtype
    tf32: bool


F64 = Precision(torch.float64, False)
TF32 = Precision(torch.float32, True)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to 10 mantissa bits (nearest, ties away)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


# --- geometry ---------------------------------------------------------------

def polar(scan: torch.Tensor, gate: dict, dt) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw rows ``(..., N, 3)`` -> gated points ``(..., N, 2)`` (zero where
    not kept) and the keep mask."""
    q, a, d = scan[..., 0].to(dt), scan[..., 1].to(dt), scan[..., 2].to(dt)
    keep = (d > gate["min_dist_mm"]) & (d < gate["max_dist_mm"]) & (q > gate["min_quality"])
    if gate["front_arc_only"]:
        keep &= (a <= gate["front_arc_lo_deg"]) | (a >= gate["front_arc_hi_deg"])
    rad = torch.deg2rad(a)
    xy = torch.stack([d * torch.cos(rad), gate["y_sign"] * d * torch.sin(rad)], dim=-1)
    return torch.where(keep[..., None], xy, torch.zeros_like(xy)), keep


def apply(pose: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """``R(theta) p + t`` for ``(B, N, 2)`` points under ``(B, 3)`` poses."""
    c, s = torch.cos(pose[:, 2])[:, None], torch.sin(pose[:, 2])[:, None]
    x, y = xy[..., 0], xy[..., 1]
    return torch.stack([c * x - s * y + pose[:, 0:1], s * x + c * y + pose[:, 1:2]], dim=-1)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a o b``: apply ``b`` first."""
    c, s = torch.cos(a[:, 2]), torch.sin(a[:, 2])
    return torch.stack([c * b[:, 0] - s * b[:, 1] + a[:, 0], s * b[:, 0] + c * b[:, 1] + a[:, 1],
                        a[:, 2] + b[:, 2]], dim=-1)


def inverse(p: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(p[:, 2]), torch.sin(p[:, 2])
    return torch.stack([-(c * p[:, 0] + s * p[:, 1]), s * p[:, 0] - c * p[:, 1], -p[:, 2]], dim=-1)


def extrapolate(pose: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Constant velocity: the last motion applied once more."""
    return compose(compose(pose, inverse(prev)), pose)


# --- point sets ---------------------------------------------------------------

def sqdist(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """``(B, N, M)`` squared distances of ``(B, N, 2)`` and ``(B, M, 2)``."""
    if prec.tf32:
        centre = b.mean(dim=1, keepdim=True)
        a32, b32 = (a - centre).to(torch.float32), (b - centre).to(torch.float32)
        cross = round_tf32(a32) @ round_tf32(b32).transpose(1, 2)
        return torch.clamp((a32 * a32).sum(-1)[..., None] + (b32 * b32).sum(-1)[:, None, :] - 2.0 * cross, min=0.0)
    dx = a[:, :, None, 0] - b[:, None, :, 0]
    dy = a[:, :, None, 1] - b[:, None, :, 1]
    return dx * dx + dy * dy


def nearest(a, b, b_valid, prec: Precision, cells: int = 200_000_000):
    """Nearest valid ``b`` for every ``a``: ``(d2 (B, N), idx (B, N))``;
    ``inf`` where ``b`` has no valid point.  Taken in blocks of robots, or of
    one robot's points, of at most ``cells`` pairs."""
    n, m = a.shape[1], max(1, b.shape[1])
    robots = max(1, cells // max(1, n * m))
    rows = n if robots > 1 else max(1, cells // m)
    d2s, idxs = [], []
    for i in range(0, a.shape[0], robots):
        sl = slice(i, i + robots)
        parts = [sqdist(a[sl, j:j + rows], b[sl], prec).masked_fill(~b_valid[sl, None, :], float("inf")).min(dim=-1)
                 for j in range(0, n, rows)]
        d2s.append(torch.cat([p.values for p in parts], 1))
        idxs.append(torch.cat([p.indices for p in parts], 1))
    return torch.cat(d2s), torch.cat(idxs)


def voxel(xy: torch.Tensor, valid: torch.Tensor, size: float):
    """Origin-anchored voxel means, one point a voxel, packed at the front in
    key order (key = column-major voxel index): ``(B, N, 2), (B, N)``."""
    ij = torch.clamp(torch.floor(xy / size).to(torch.int64) + _OFF, 0, _STRIDE - 1)
    key = torch.where(valid, ij[..., 0] * _STRIDE + ij[..., 1], torch.full_like(ij[..., 0], _NO_KEY))
    ks, perm = torch.sort(key, dim=1, stable=True)
    first = torch.ones_like(ks, dtype=torch.bool)
    first[:, 1:] = ks[:, 1:] != ks[:, :-1]
    seg = torch.cumsum(first.to(torch.int64), dim=1) - 1
    w = (ks != _NO_KEY).to(xy.dtype)
    pts = torch.gather(xy, 1, perm[..., None].expand(-1, -1, 2)) * w[..., None]
    sums = torch.zeros_like(xy).scatter_add_(1, seg[..., None].expand(-1, -1, 2), pts)
    cnt = torch.zeros_like(w).scatter_add_(1, seg, w)
    out_valid = cnt > 0
    out = sums / torch.clamp(cnt, min=1.0)[..., None]
    return torch.where(out_valid[..., None], out, torch.zeros_like(out)), out_valid


def compact(xy: torch.Tensor, valid: torch.Tensor, capacity: int):
    """Valid points to the front in their order, cut or padded to ``capacity``."""
    order = torch.sort((~valid).to(torch.int8), dim=1, stable=True).indices
    xy = torch.gather(xy, 1, order[..., None].expand(-1, -1, 2))
    valid = torch.gather(valid, 1, order)
    n = xy.shape[1]
    if capacity <= n:
        return xy[:, :capacity], valid[:, :capacity]
    pad = capacity - n
    return (torch.cat([xy, xy.new_zeros((xy.shape[0], pad, 2))], 1),
            torch.cat([valid, valid.new_zeros((valid.shape[0], pad))], 1))


def outlier_keep(xy: torch.Tensor, valid: torch.Tensor, k: int, ratio: float, prec: Precision) -> torch.Tensor:
    """Open3D's statistical filter: keep a point whose mean distance to its
    (up to) ``k`` nearest other valid points is at most the cloud's mean of
    that statistic plus ``ratio`` standard deviations."""
    d2 = sqdist(xy, xy, prec)
    n = xy.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=xy.device)
    d2 = d2.masked_fill(eye | ~valid[:, None, :], float("inf"))
    near = torch.topk(d2, min(k, n), dim=-1, largest=False).values
    real = torch.isfinite(near)
    mean_k = torch.where(real, torch.sqrt(torch.where(real, near, 0.0)), 0.0).sum(-1) / torch.clamp(real.sum(-1), min=1)
    w = valid.to(xy.dtype)
    cnt = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    vals = torch.where(valid, mean_k, 0.0)
    mu = vals.sum(-1, keepdim=True) / cnt
    var = (w * (vals - mu) ** 2).sum(-1, keepdim=True) / cnt
    return valid & (mean_k <= mu + ratio * torch.sqrt(var))


# --- registration ---------------------------------------------------------------

class Registration(NamedTuple):
    pose: torch.Tensor    # (B, 3)
    rmse: torch.Tensor    # (B,) inf when degenerate
    iters: torch.Tensor   # (B,) iterations run before convergence
    n_src: torch.Tensor   # (B,) valid source points
    n_tgt: torch.Tensor   # (B,) valid target points


def _kabsch(src, dst, w):
    wsum = w.sum(-1)
    safe = torch.clamp(wsum, min=1e-30)[:, None]
    ca = (src * w[..., None]).sum(1) / safe
    cb = (dst * w[..., None]).sum(1) / safe
    a, b = src - ca[:, None], dst - cb[:, None]
    sxx = (w * (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1])).sum(-1)
    sxy = (w * (a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])).sum(-1)
    th = torch.atan2(sxy, sxx)
    c, s = torch.cos(th), torch.sin(th)
    t = torch.stack([cb[:, 0] - (c * ca[:, 0] - s * ca[:, 1]), cb[:, 1] - (s * ca[:, 0] + c * ca[:, 1])], -1)
    ok = wsum >= 1e-6
    return torch.where(ok[:, None], torch.cat([t, th[:, None]], -1), torch.zeros_like(torch.cat([t, th[:, None]], -1)))


def icp(src, src_valid, tgt, tgt_valid, init, icp_cfg: dict, prec: Precision) -> Registration:
    """Gated point-to-point ICP of ``src`` onto ``tgt`` from ``init``, each
    registration stopping once its mean inlier distance moves by less than
    the tolerance; the RMSE is over the inliers at the final pose."""
    thr2 = float(icp_cfg["threshold_mm"]) ** 2
    pose = init.clone()
    b = src.shape[0]
    prev_err = torch.full((b,), 1e30, dtype=pose.dtype, device=pose.device)
    done = torch.zeros(b, dtype=torch.bool, device=pose.device)
    iters = torch.zeros(b, dtype=torch.int64, device=pose.device)
    for _ in range(int(icp_cfg["max_iterations"])):
        if bool(done.all()):
            break
        moved = apply(pose, src)
        d2, idx = nearest(moved, tgt, tgt_valid, prec)
        w = src_valid & (d2 < thr2)
        matched = torch.gather(tgt, 1, idx[..., None].expand(-1, -1, 2))
        wf = w.to(pose.dtype)
        new = compose(_kabsch(moved, matched, wf), pose)
        err = torch.where(w, torch.sqrt(torch.where(w, d2, 0.0)), 0.0).sum(-1) / torch.clamp(wf.sum(-1), min=1.0)
        conv = (prev_err - err).abs() < float(icp_cfg["tolerance"])
        pose = torch.where(done[:, None], pose, new)
        iters = iters + (~done).to(torch.int64)
        prev_err, done = err, done | conv
    d2, _ = nearest(apply(pose, src), tgt, tgt_valid, prec)
    inl = src_valid & (d2 < thr2)
    n_in = inl.sum(-1)
    rmse = torch.sqrt(torch.where(inl, d2, 0.0).sum(-1) / torch.clamp(n_in, min=1).to(pose.dtype))
    n_src, n_tgt = src_valid.sum(-1), tgt_valid.sum(-1)
    bad = (n_src < icp_cfg["min_points"]) | (n_tgt < icp_cfg["min_points"]) | (n_in == 0)
    return Registration(torch.where(bad[:, None], init, pose), torch.where(bad, float("inf"), rmse),
                        iters, n_src, n_tgt)


def icp_iterates(src, src_valid, tgt, tgt_valid, init, icp_cfg: dict, prec: Precision) -> torch.Tensor:
    """``(iterations + 1, B, 3)``: the start and the pose after each of
    ``max_iterations`` iterations of `icp`, none stopping (the stop is
    `icp`'s; this shows where a registration would have gone on)."""
    thr2 = float(icp_cfg["threshold_mm"]) ** 2
    poses = [init.clone()]
    for _ in range(int(icp_cfg["max_iterations"])):
        moved = apply(poses[-1], src)
        d2, idx = nearest(moved, tgt, tgt_valid, prec)
        w = (src_valid & (d2 < thr2)).to(init.dtype)
        matched = torch.gather(tgt, 1, idx[..., None].expand(-1, -1, 2))
        poses.append(compose(_kabsch(moved, matched, w), poses[-1]))
    return torch.stack(poses)


# --- occupancy ----------------------------------------------------------------

def grid_shape(map_cfg: dict) -> tuple[int, int]:
    res = map_cfg["resolution_mm_per_px"]
    return int(map_cfg["height_mm"] / res), int(map_cfg["width_mm"] / res)


def to_px(xy: torch.Tensor, map_cfg: dict):
    """World mm -> grid cell ``(px, py)``: ``px = W // 2 + x / res``,
    ``py = H // 2 - y / res``, truncated toward zero."""
    h, w = grid_shape(map_cfg)
    res = float(map_cfg["resolution_mm_per_px"])
    px = torch.trunc(w // 2 + xy[..., 0] / res)
    return px.to(torch.int64), torch.trunc(h // 2 - xy[..., 1] / res).to(torch.int64)


def raster(occ: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor, robot: torch.Tensor, map_cfg: dict,
           occ_cfg: dict, accept: torch.Tensor | None = None) -> torch.Tensor:
    """One scan's update of each robot's grid ``(B, H, W)``: along the
    Bresenham line from the robot's cell to each endpoint inside the window
    (``window_px`` either side of the robot), body cells decay until the
    first one already at ``block_threshold`` when the scan began, which ends
    the ray; an unblocked ray's endpoint is reinforced.  Per cell ``p *=
    decay^free``, then ``p = min(1, p + inc * ends)``.  A new tensor."""
    b, h, w = occ.shape
    win = int(occ_cfg["window_px"])
    rx, ry = to_px(robot, map_cfg)
    ex, ey = to_px(pts, map_cfg)
    rxe, rye = rx[:, None], ry[:, None]
    live = valid & (ex >= torch.clamp(rxe - win, min=0)) & (ex < torch.clamp(rxe + win, max=w)) \
        & (ey >= torch.clamp(rye - win, min=0)) & (ey < torch.clamp(rye + win, max=h))
    dx, dy = (ex - rxe).abs(), (ey - rye).abs()
    sx = torch.where(ex >= rxe, 1, -1)
    sy = torch.where(ey >= rye, 1, -1)
    xdrv = dx > dy
    length = torch.maximum(dx, dy)
    err = torch.where(xdrv, dx, dy)  # twice the reference's dx / 2 (or dy / 2)
    x, y = rxe.expand_as(ex).clone(), rye.expand_as(ey).clone()
    p0 = occ.reshape(b, -1)
    free = torch.zeros_like(p0)
    ends = torch.zeros_like(p0)
    alive = live.clone()
    top = int(torch.where(live, length, 0).max()) if live.any() else -1
    for i in range(top + 1):
        at = alive & (i <= length)
        cell = torch.clamp(y, 0, h - 1) * w + torch.clamp(x, 0, w - 1)
        body = at & (i < length)
        end = at & (i == length)
        blocked = body & (torch.gather(p0, 1, cell) >= occ_cfg["block_threshold"])
        alive = alive & ~blocked
        free.scatter_add_(1, cell, (body & ~blocked).to(p0.dtype))
        ends.scatter_add_(1, cell, end.to(p0.dtype))
        err_x = err - 2 * dy
        err_y = err - 2 * dx
        step_y = xdrv & (err_x < 0)
        step_x = ~xdrv & (err_y < 0)
        y = y + torch.where(xdrv, torch.where(step_y, sy, 0), sy)
        x = x + torch.where(xdrv, sx, torch.where(step_x, sx, 0))
        err = torch.where(xdrv, err_x + torch.where(step_y, 2 * dx, 0), err_y + torch.where(step_x, 2 * dy, 0))
    p = p0 * torch.pow(torch.tensor(occ_cfg["p_free_decay"], dtype=p0.dtype, device=p0.device), free)
    p = torch.clamp(p + occ_cfg["p_occ_inc"] * ends, max=1.0)
    if accept is not None:
        p = torch.where(accept[:, None], p, p0)
    return p.reshape(b, h, w)


def keep_free(xy, valid, occ, map_cfg: dict, threshold: float, rx=None, ry=None, half=None):
    """Drop points whose cell is confidently free (``< threshold``); points
    off the grid are kept.  With ``half``, only points inside the window of
    ``half`` cells either side of ``(rx, ry)`` are looked at."""
    b, h, w = occ.shape
    px, py = to_px(xy, map_cfg)
    oob = (px < 0) | (px >= w) | (py < 0) | (py >= h)
    idx = torch.clamp(py, 0, h - 1) * w + torch.clamp(px, 0, w - 1)
    hold = torch.gather(occ.reshape(b, -1), 1, idx) >= threshold
    if half is None:
        return valid & (oob | hold)
    ww, wh = min(2 * half, w), min(2 * half, h)
    x1 = torch.clamp(rx - half, 0, w - ww)[:, None]
    y1 = torch.clamp(ry - half, 0, h - wh)[:, None]
    inside = (px >= x1) & (px < x1 + ww) & (py >= y1) & (py < y1 + wh)
    return valid & (~inside | hold)


def prune(xy, valid, occ, robot, map_cfg: dict, occ_cfg: dict):
    margin = int(occ_cfg["prune_window_margin_px"])
    if margin < 0:
        return keep_free(xy, valid, occ, map_cfg, occ_cfg["free_threshold"])
    rx, ry = to_px(robot, map_cfg)
    return keep_free(xy, valid, occ, map_cfg, occ_cfg["free_threshold"], rx, ry, int(occ_cfg["window_px"]) + margin)


def near_previous(xy, valid, prev_xy, prev_valid, distance: float, prec: Precision):
    """The dynamic-points filter: keep a point whose nearest point of the
    previous accepted scan is closer than ``distance``; keep all when there
    is no previous scan."""
    d2, _ = nearest(xy, prev_xy, prev_valid, prec)
    keep = valid & (torch.sqrt(d2) < distance)
    return torch.where(prev_valid.any(-1, keepdim=True), keep, valid)


# --- the steps ----------------------------------------------------------------

class Tracked(NamedTuple):
    """What registration decides, for every robot of a step."""
    xy: torch.Tensor        # (B, N, 2) gated, filtered points (sensor frame)
    valid: torch.Tensor     # (B, N)
    enough: torch.Tensor    # (B,)
    reg: Registration
    accepted: torch.Tensor  # (B,)


def track(scans, pose, prev_pose, map_xy, map_valid, cfg: dict, prec: Precision) -> Tracked:
    """Gate, filter, pick the local map, voxel the scan and register it from
    the constant-velocity prediction (each robot against its own map, or
    every robot against one shared map ``(CAP, 2)``)."""
    xy, valid, enough, icp_in = track_inputs(scans, pose, prev_pose, map_xy, map_valid, cfg, prec)
    reg = icp(*icp_in, cfg["icp"], prec)
    accepted = enough & (reg.rmse <= cfg["icp"]["max_rmse"])
    return Tracked(xy, valid, enough, reg, accepted)


def track_inputs(scans, pose, prev_pose, map_xy, map_valid, cfg: dict, prec: Precision):
    """`track` up to the registration: ``(gated xy, valid, enough, (source,
    source valid, target, target valid, initial pose))``."""
    dt = prec.dtype
    xy, valid = polar(scans, cfg["gate"], dt)
    if cfg["use_outlier_filter"]:
        valid = outlier_keep(xy, valid, int(cfg["outlier_nb_neighbors"]), float(cfg["outlier_std_ratio"]), prec)
    enough = valid.sum(-1) >= cfg["icp"]["min_points"]
    pose, prev_pose = pose.to(dt), prev_pose.to(dt)
    b = scans.shape[0]
    if map_xy.dim() == 2:
        map_xy, map_valid = map_xy[None].expand(b, -1, -1), map_valid[None].expand(b, -1)
    map_xy = map_xy.to(dt)
    d2 = ((map_xy - pose[:, None, :2]) ** 2).sum(-1)
    local = map_valid & (d2 < float(cfg["local_map_radius_mm"]) ** 2)
    use_local = local.sum(-1, keepdim=True) >= cfg["min_local_map_points"]
    tgt_valid = torch.where(use_local, local, map_valid)
    tgt_xy = map_xy
    if cfg["local_map_capacity"] < cfg["map_capacity"]:
        tgt_xy, tgt_valid = compact(map_xy, tgt_valid, int(cfg["local_map_capacity"]))
    ds_xy, ds_valid = voxel(xy, valid, float(cfg["icp"]["voxel_size_mm"]))
    init = extrapolate(pose, prev_pose) if cfg["motion_model"] else pose
    return xy, valid, enough, (ds_xy, ds_valid, tgt_xy, tgt_valid, init)


def track_blocks(scans, pose, prev_pose, map_xy, map_valid, cfg: dict, prec: Precision, block: int = 16):
    """`track` in blocks of robots (so that the distance slabs fit)."""
    parts = []
    for i in range(0, scans.shape[0], block):
        sl = slice(i, i + block)
        shared = map_xy.dim() == 2
        parts.append(track(scans[sl], pose[sl], prev_pose[sl], map_xy if shared else map_xy[sl],
                           map_valid if shared else map_valid[sl], cfg, prec))
    reg = Registration(*(torch.cat(f) for f in zip(*(p.reg for p in parts))))
    return Tracked(*(torch.cat([getattr(p, f) for p in parts]) for f in ("xy", "valid", "enough")), reg,
                   torch.cat([p.accepted for p in parts]))


class RobotState(NamedTuple):
    """A fleet robot's state, each field with a leading robot axis."""
    pose: torch.Tensor
    prev_pose: torch.Tensor
    map_xy: torch.Tensor
    map_valid: torch.Tensor
    occ: torch.Tensor
    prev_xy: torch.Tensor
    prev_valid: torch.Tensor


def _maintain(tick: int, cfg: dict) -> bool:
    return (int(tick) + 1) % int(cfg["maintenance_interval"]) == 0


def fleet_update(st: RobotState, tr: Tracked, tick: int, cfg: dict, prec: Precision) -> RobotState:
    """The realtime update of independent robots after `track`: on accept
    the pose and the deduplicated, dynamic- and occupancy-filtered points
    are taken; either way the grid is updated (where there were enough
    points) from the last accepted scan deduplicated at twice the grid's
    resolution; on the maintenance tick the map is pruned and, over the
    trigger, downsampled.  A robot without enough points keeps its state."""
    dt = prec.dtype
    acc, enough = tr.accepted, tr.enough
    pose, prev_xy = st.pose.to(dt), st.prev_xy.to(dt)
    occ = st.occ.to(dt)
    new_pose = torch.where(acc[:, None], tr.reg.pose, pose)
    new_global = apply(tr.reg.pose, tr.xy)
    cur_xy = torch.where(acc[:, None, None], new_global, prev_xy)
    cur_valid = torch.where(acc[:, None], tr.valid, st.prev_valid)
    dd_xy, dd_valid = voxel(new_global, tr.valid, float(cfg["duplicate_voxel_mm"]))
    occ_xy, occ_valid = voxel(cur_xy, cur_valid, 2.0 * float(cfg["map"]["resolution_mm_per_px"]))
    add = near_previous(dd_xy, dd_valid, prev_xy, st.prev_valid, float(cfg["dynamic_distance_mm"]), prec)
    add = keep_free(dd_xy, add, occ, cfg["map"], cfg["occupancy"]["free_threshold"])
    big_xy = torch.cat([st.map_xy.to(dt), dd_xy], 1)
    big_valid = torch.cat([st.map_valid, add & acc[:, None]], 1)
    new_occ = raster(occ, occ_xy, occ_valid, new_pose[:, :2], cfg["map"], cfg["occupancy"], enough)
    if _maintain(tick, cfg):
        big_valid = prune(big_xy, big_valid, new_occ, new_pose[:, :2], cfg["map"], cfg["occupancy"])
        ds_xy, ds_valid = voxel(big_xy, big_valid, float(cfg["map_downsample_voxel_mm"]))
        over = big_valid.sum(-1) > cfg["map_downsample_trigger"]
        big_xy = torch.where(over[:, None, None], ds_xy, big_xy)
        big_valid = torch.where(over[:, None], ds_valid, big_valid)
    map_xy, map_valid = compact(big_xy, big_valid, int(cfg["map_capacity"]))
    e1, e2, e3 = enough[:, None], enough[:, None, None], enough[:, None]
    return RobotState(
        pose=torch.where(e1, new_pose, pose), prev_pose=torch.where(e1, pose, st.prev_pose.to(dt)),
        map_xy=torch.where(e2, map_xy, st.map_xy.to(dt)), map_valid=torch.where(e3, map_valid, st.map_valid),
        occ=new_occ, prev_xy=torch.where(e2, cur_xy, prev_xy), prev_valid=torch.where(e3, cur_valid, st.prev_valid))


def fresh_grid(b: int, cfg: dict, dt, device) -> torch.Tensor:
    return torch.full((b, *grid_shape(cfg["map"])), 0.5, dtype=dt, device=device)


def fleet_init(first: torch.Tensor, cfg: dict, prec: Precision) -> RobotState:
    """Each robot's map is its first scan's gated points (in their slots),
    its grid a fresh one updated from the origin."""
    dt = prec.dtype
    xy, valid = polar(first, cfg["gate"], dt)
    b, n = valid.shape
    cap = int(cfg["map_capacity"])
    m = min(n, cap)
    map_xy = xy.new_zeros((b, cap, 2))
    map_valid = valid.new_zeros((b, cap))
    map_xy[:, :m], map_valid[:, :m] = xy[:, :m], valid[:, :m]
    zeros = xy.new_zeros((b, 3))
    occ = raster(fresh_grid(b, cfg, dt, first.device), xy, valid, zeros[:, :2], cfg["map"], cfg["occupancy"])
    return RobotState(zeros, zeros.clone(), map_xy, map_valid, occ, torch.zeros_like(xy), torch.zeros_like(valid))


class SharedState(NamedTuple):
    """One map and one grid for all robots; each robot's tracking state."""
    map_xy: torch.Tensor      # (CAP, 2)
    map_valid: torch.Tensor   # (CAP,)
    occ: torch.Tensor         # (H, W)
    pose: torch.Tensor        # (R, 3)
    prev_pose: torch.Tensor
    prev_xy: torch.Tensor     # (R, N, 2)
    prev_valid: torch.Tensor  # (R, N)


P_EPS = 1e-6


def merge(base: torch.Tensor, occ_of, r: int, block: int = 16) -> torch.Tensor:
    """Simultaneous composition of the robots' updates of one grid: the
    robots' log-ratios to ``base`` summed, ``p`` clipped into ``[1e-6, 1]``
    before the log and after the exp.  ``occ_of(slice)`` gives a block of
    the robots' updated grids."""
    log_base = torch.log(torch.clamp(base, P_EPS, 1.0))
    d = torch.zeros_like(base)
    for i in range(0, r, block):
        d += (torch.log(torch.clamp(occ_of(slice(i, i + block)), P_EPS, 1.0)) - log_base).sum(0)
    return torch.clamp(torch.exp(log_base + d), P_EPS, 1.0)


def shared_init(first: torch.Tensor, cfg: dict, prec: Precision) -> SharedState:
    """The map seeded with every robot's gated first-scan points in robot
    order; the grid the merge of each robot's update of a fresh grid from
    the origin; every pose the identity."""
    dt = prec.dtype
    xy, valid = polar(first, cfg["gate"], dt)
    r = xy.shape[0]
    map_xy, map_valid = compact(xy.reshape(1, -1, 2), valid.reshape(1, -1), int(cfg["map_capacity"]))
    base = fresh_grid(1, cfg, dt, first.device)[0]
    zeros = xy.new_zeros((r, 3))

    def occ_of(sl):
        n = xy[sl].shape[0]
        return raster(base.expand(n, -1, -1), xy[sl], valid[sl], zeros[sl, :2], cfg["map"], cfg["occupancy"])

    return SharedState(map_xy[0], map_valid[0], merge(base, occ_of, r), zeros, zeros.clone(),
                       torch.zeros_like(xy), torch.zeros_like(valid))


def shared_step(st: SharedState, scans: torch.Tensor, tick: int, cfg: dict, prec: Precision):
    """One step of R robots building one map: every robot registers against
    the whole map masked to its radius, the candidates of all robots (robot
    order) are filtered against the state before the step, each robot
    updates its own copy of the grid and the copies merge; on the
    maintenance tick the map is pruned about the robots' mean position.
    Returns ``(state, Tracked)``."""
    dt = prec.dtype
    tr = track_blocks(scans, st.pose, st.prev_pose, st.map_xy, st.map_valid, cfg, prec)
    acc, enough = tr.accepted, tr.enough
    pose, prev_xy = st.pose.to(dt), st.prev_xy.to(dt)
    occ = st.occ.to(dt)
    r = scans.shape[0]
    new_pose = torch.where(acc[:, None], tr.reg.pose, pose)
    new_global = apply(tr.reg.pose, tr.xy)
    cur_xy = torch.where(acc[:, None, None], new_global, prev_xy)
    cur_valid = torch.where(acc[:, None], tr.valid, st.prev_valid)
    dd_xy, dd_valid = voxel(new_global, tr.valid, float(cfg["duplicate_voxel_mm"]))
    add = near_previous(dd_xy, dd_valid, prev_xy, st.prev_valid, float(cfg["dynamic_distance_mm"]), prec)
    add = keep_free(dd_xy, add, occ.expand(r, -1, -1), cfg["map"], cfg["occupancy"]["free_threshold"])
    add = add & (acc & enough)[:, None]
    occ_xy, occ_valid = voxel(cur_xy, cur_valid, 2.0 * float(cfg["map"]["resolution_mm_per_px"]))

    def occ_of(sl):
        n = occ_xy[sl].shape[0]
        return raster(occ.expand(n, -1, -1), occ_xy[sl], occ_valid[sl] & enough[sl, None], new_pose[sl, :2],
                      cfg["map"], cfg["occupancy"])

    new_occ = merge(occ, occ_of, r)
    new_pose = torch.where(enough[:, None], new_pose, pose)
    big_xy = torch.cat([st.map_xy.to(dt), dd_xy.reshape(-1, 2)])[None]
    big_valid = torch.cat([st.map_valid, add.reshape(-1)])[None]
    if _maintain(tick, cfg):
        anchor = new_pose[:, :2].sum(0, keepdim=True) / r
        big_valid = prune(big_xy, big_valid, new_occ[None], anchor, cfg["map"], cfg["occupancy"])
        ds_xy, ds_valid = voxel(big_xy, big_valid, float(cfg["map_downsample_voxel_mm"]))
        over = big_valid.sum() > cfg["map_downsample_trigger"]
        big_xy = torch.where(over, ds_xy, big_xy)
        big_valid = torch.where(over, ds_valid, big_valid)
    map_xy, map_valid = compact(big_xy, big_valid, int(cfg["map_capacity"]))
    return SharedState(map_xy[0], map_valid[0], new_occ, new_pose, pose, cur_xy, cur_valid), tr
