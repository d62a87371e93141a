"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints a line; any failed check raises, so the script exits
non-zero):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels (``nvcc``, first use) and print the build time;
  3. hold each kernel (K1 ICP, K2 raster, K3 nearest neighbour) against its
     plain PyTorch version on the card, at the slice's shapes, and time both
     (CUDA events) and, for K3, the library call ``torch.cdist(...).min(1)``;
     then again at small edge cases (ragged sizes, nothing valid, a window
     clamped at the grid's corner);
  4. the main path: ``Slam(cfg).run(scans)`` at the full-width offline
     configuration (without the GICP rescue) over a seeded synthetic
     warehouse, with launch counters reset just before and read just after;
     five steps under PyTorch's sync debug mode (no host synchronisation);
     then the first scans again on ``device="cpu"`` (plain versions) and a
     comparison of poses and accept flags;
  5. one JSON line listing the kernels, then the card line, then the result
     line ``{"ok": true, "device": {...}}`` last.

The synthetic scan generator (`synthetic_sequence`) lives here so the CPU
tests can import it; it is not part of the package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

# ---------------------------------------------------------------- synthetic data


def _box(x0, y0, x1, y1):
    return [(x0, y0, x1, y0), (x1, y0, x1, y1), (x1, y1, x0, y1), (x0, y1, x0, y0)]


def warehouse_segments(half_x: float, half_y: float) -> np.ndarray:
    """Walls of a ``2 half_x x 2 half_y`` mm hall, a central rack row and two
    side rows of rack bays (1.2 m bays, 0.3 m gaps), plus pillars: wall
    segments ``(M, 4)`` as ``[x0, y0, x1, y1]``."""
    segs = _box(-half_x, -half_y, half_x, half_y)
    bay, gap, depth = 1200.0, 300.0, 900.0
    for yc in (0.0, -0.6 * half_y, 0.6 * half_y):
        x = -0.55 * half_x
        while x + bay <= 0.55 * half_x:
            segs += _box(x, yc - depth / 2, x + bay, yc + depth / 2)
            x += bay + gap
    for px, py in ((-0.8 * half_x, -0.3 * half_y), (0.8 * half_x, 0.3 * half_y),
                   (0.3 * half_x, -0.85 * half_y), (-0.35 * half_x, 0.85 * half_y)):
        segs += _box(px - 200, py - 200, px + 200, py + 200)
    return np.asarray(segs, np.float64)


def loop_path(n: int, half_x: float, half_y: float, radius: float, step_mm: float) -> np.ndarray:
    """Ground-truth poses ``(n, 3)`` every ``step_mm`` along a rounded
    rectangle around the central rack row, heading along the path."""
    straight_x, straight_y = 2 * (half_x - radius), 2 * (half_y - radius)
    arc = 0.5 * np.pi * radius
    legs = [straight_x, arc, straight_y, arc, straight_x, arc, straight_y, arc]
    total = float(sum(legs))
    out = []
    for k in range(n):
        s = (k * step_mm) % total
        x, y, th = -half_x + radius, -half_y, 0.0  # start of the bottom straight
        for leg, length in enumerate(legs):
            if s <= length:
                break
            s -= length
            x, y, th = _advance(x, y, th, leg, length, radius)
        x, y, th = _advance(x, y, th, leg, s, radius)
        out.append((x, y, th))
    return np.asarray(out, np.float64)


def _advance(x, y, th, leg, s, radius):
    if leg % 2 == 0:  # straight
        return x + s * np.cos(th), y + s * np.sin(th), th
    a = s / radius  # left turn about the centre on the left of the heading
    cx, cy = x - radius * np.sin(th), y + radius * np.cos(th)
    th2 = th + a
    return cx + radius * np.sin(th2), cy - radius * np.cos(th2), th2


def raycast(pose, segs: np.ndarray, angles_deg: np.ndarray, y_sign: float = -1.0) -> np.ndarray:
    """Range (mm) to the nearest wall along each beam; ``inf`` for no hit.
    A beam at angle ``a`` points along ``(cos a, y_sign sin a)`` in the
    sensor frame, the gate's conversion (`GateConfig.y_sign`)."""
    x, y, th = pose
    a = np.deg2rad(angles_deg)
    lx, ly = np.cos(a), y_sign * np.sin(a)
    dx = np.cos(th) * lx - np.sin(th) * ly
    dy = np.sin(th) * lx + np.cos(th) * ly
    ax, ay = segs[:, 0] - x, segs[:, 1] - y
    ex, ey = segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1]
    den = dx[:, None] * ey[None] - dy[:, None] * ex[None]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (ax[None] * ey[None] - ay[None] * ex[None]) / den
        u = (ax[None] * dy[:, None] - ay[None] * dx[:, None]) / den
    hit = (np.abs(den) > 1e-9) & (t > 1.0) & (u >= 0.0) & (u <= 1.0)
    return np.where(hit, t, np.inf).min(axis=1)


def synthetic_sequence(n_scans: int, seed: int, *, half_x: float = 10000.0, half_y: float = 6000.0,
                       path_half_x: float = 7000.0, path_half_y: float = 1800.0,
                       radius: float = 1800.0, step_mm: float = 150.0, beams: int = 360,
                       noise_mm: float = 10.0, dropout: float = 0.05, max_range_mm: float = 10000.0):
    """Seeded synthetic warehouse replay: ``(scans (n, beams, 3) float32
    [quality, angle_deg, distance_mm], ground-truth poses (n, 3))``.  Beams
    with no return within ``max_range_mm`` and random dropouts come back as
    all-zero rows quality 0 (the gates drop them)."""
    rng = np.random.default_rng(seed)
    segs = warehouse_segments(half_x, half_y)
    poses = loop_path(n_scans, path_half_x, path_half_y, radius, step_mm)
    angles = np.arange(beams) * (360.0 / beams)
    scans = np.zeros((n_scans, beams, 3), np.float32)
    for k, pose in enumerate(poses):
        rng_mm = raycast(pose, segs, angles) + rng.normal(0.0, noise_mm, beams)
        ok = np.isfinite(rng_mm) & (rng_mm < max_range_mm) & (rng.random(beams) >= dropout)
        scans[k, :, 0] = np.where(ok, 15.0 + rng.integers(0, 40, beams), 0.0)
        scans[k, :, 1] = angles
        scans[k, :, 2] = np.where(ok, rng_mm, 0.0)
    return scans, poses


def relative_poses(poses: np.ndarray) -> np.ndarray:
    """Ground truth in the first scan's frame: ``T_0^-1 T_k``."""
    x0, y0, t0 = poses[0]
    c, s = np.cos(t0), np.sin(t0)
    dx, dy = poses[:, 0] - x0, poses[:, 1] - y0
    th = np.arctan2(np.sin(poses[:, 2] - t0), np.cos(poses[:, 2] - t0))
    return np.stack([c * dx + s * dy, -s * dx + c * dy, th], axis=1)


def map_points_along(segs: np.ndarray, n: int, rng, noise_mm: float = 10.0) -> np.ndarray:
    """``n`` noisy points spread over the walls by length."""
    lengths = np.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1])
    which = rng.choice(len(segs), size=n, p=lengths / lengths.sum())
    u = rng.random(n)
    pts = segs[which, :2] + u[:, None] * (segs[which, 2:] - segs[which, :2])
    return pts + rng.normal(0.0, noise_mm, (n, 2))


# ---------------------------------------------------------------- measurement

PEAK_FP32 = 67e12   # FP32 operations/s outside the tensor cores (H100 SXM data sheet)
PEAK_BYTES = 3.35e12  # HBM bytes/s (H100 SXM data sheet)


def _bound(ops: float, nbytes: float):
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_events(torch, prof) -> list:
    """The profiler's per-name averages of device-side events (kernels,
    memcpys, memsets); host operators are left out so nothing counts twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages() if e.device_type == cuda and e.self_device_time_total > 0]


def _device_profile(torch, fn, reps: int) -> dict:
    """Device time per call by event name (ms): the kernels' own times that
    ``torch.profiler`` records over ``reps`` calls.  Raises if it records
    none, so a time always means device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {e.key: e.self_device_time_total / reps / 1e3 for e in _kernel_events(torch, prof)}
    if not times:
        raise RuntimeError("the profiler recorded no device time")
    return times


def _device_ms(torch, fn, reps: int) -> float:
    """Device time per call (ms), summed over the call's device events."""
    return sum(_device_profile(torch, fn, reps).values())


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def slice_config():
    """The slice's configuration: the CLI's default ``offline`` preset at full
    width, without the GICP second chance (a later slice)."""
    import icp_slam_yolo_tpu_torch as port

    return port.OFFLINE_CONFIG.replace(icp=dataclasses.replace(port.OFFLINE_CONFIG.icp, rescue_estimator=""))


def check_kernels(cfg) -> dict:
    """Phase 3: each kernel against its plain version on the card, at the
    slice's shapes, with times.  Returns the kernels' rows (no launches)."""
    import torch

    from icp_slam_yolo_tpu_torch.ops import geometry as geo
    from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import _prepare, icp_fused, icp_fused_plain
    from icp_slam_yolo_tpu_torch.ops.pallas.nn_kernel import nn_argmin, nn_argmin_plain
    from icp_slam_yolo_tpu_torch.ops.pallas.raster_fused import raster_update, raster_update_plain
    from icp_slam_yolo_tpu_torch.ops.raster import window_dims, world_to_px
    from icp_slam_yolo_tpu_torch.ops.voxel import voxel_downsample

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = cfg.n_max
    kernels = {}

    # K3: nearest neighbour, duplicated targets for ties
    base = rng.uniform(-5000, 5000, (n // 2, 2))
    tgt = torch.tensor(np.concatenate([base, base]), dtype=torch.float32, device=dev)  # duplicates: ties
    tv = torch.tensor(rng.random(n) < 0.9, device=dev)
    src = torch.tensor(rng.uniform(-5000, 5000, (n, 2)), dtype=torch.float32, device=dev)
    d_k, i_k = nn_argmin(src, tgt, tv)
    d_p, i_p = nn_argmin_plain(src, tgt, tv)
    torch.cuda.synchronize()
    err3 = float((d_k - d_p).abs().max())
    _require(bool((i_k == i_p).all()), "K3: argmin differs from the plain version (ties go to the first index)")
    _require(err3 <= 1e-6 * float(d_p.abs().max()), f"K3: d2 error {err3}")
    ms3 = _device_ms(torch, lambda: nn_argmin(src, tgt, tv), 200)
    plain3 = _device_ms(torch, lambda: nn_argmin_plain(src, tgt, tv), 50)
    lib3 = _device_ms(torch, lambda: torch.cdist(src, tgt).min(1), 200)
    wall3 = _cuda_ms(torch, lambda: nn_argmin(src, tgt, tv), 200)
    nv = int(tv.sum())
    b3 = _bound(6.0 * n * nv, n * 8 + n * 9 + n * 8)
    kernels["nn_argmin"] = dict(
        name="nn_argmin", route="cuda", source="icp_slam_yolo_tpu_torch/csrc/nn.cu",
        replaces="icp_slam_yolo_tpu/ops/pallas/nn_kernel.py:76", max_abs_err=err3,
        ms=ms3, plain_ms=plain3, bound_ms=b3[0], bound_by=b3[1], library_ms=lib3)
    print(f"[3] K3 nn_argmin {n}x{n}: idx equal, max|d2 err| {err3:.3g} (tol 1e-6 rel); "
          f"device {ms3 * 1e3:.2f} us (wall per call {wall3 * 1e3:.1f} us), plain {plain3 * 1e3:.2f} us, "
          f"cdist+min {lib3 * 1e3:.2f} us", flush=True)

    # K1: the ICP loop on a 24576-slot map holding 20k live points
    segs = warehouse_segments(10000.0, 6000.0)
    cap = cfg.map_capacity
    n_map = 20000
    map_np = np.zeros((cap, 2), np.float32)
    map_np[:n_map] = map_points_along(segs, n_map, rng)
    map_valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    map_valid[:n_map] = True
    map_xy = torch.tensor(map_np, device=dev)
    scans1, gt1 = synthetic_sequence(1, seed=1)
    scan1 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    scan1[: scans1.shape[1]] = torch.tensor(scans1[0], device=dev)
    xy, valid = geo.polar_to_cartesian(scan1, cfg.gate)
    ds_xy, ds_valid = voxel_downsample(xy, valid, cfg.icp.voxel_size_mm)
    truth = torch.tensor(gt1[0], dtype=torch.float32, device=dev)
    init = truth + torch.tensor([100.0, -80.0, 0.03], device=dev)
    kw = dict(iters=cfg.icp.max_iterations, threshold_mm=cfg.icp.threshold_mm, tolerance=cfg.icp.tolerance)
    pose_k, rmse_k, nin_k, it_k = icp_fused(ds_xy, ds_valid, map_xy, map_valid, init, **kw)
    params, tgt_c, c = _prepare(map_xy, map_valid, init)
    out_p = icp_fused_plain(ds_xy, ds_valid, tgt_c, map_valid, params, iters=kw["iters"],
                            thr2=kw["threshold_mm"] ** 2, tolerance=kw["tolerance"], anderson=False)
    torch.cuda.synchronize()
    pose_p = torch.stack([out_p[0] + c[0], out_p[1] + c[1], torch.atan2(out_p[3], out_p[2])])
    dpos = float((pose_k[:2] - pose_p[:2]).abs().max())
    dang = float((pose_k[2] - pose_p[2]).abs())
    drm = abs(float(rmse_k) - float(out_p[4]))
    n_it = int(it_k)
    _require(dpos <= 1.0 and dang <= 2e-3 and drm <= 1.0,
             f"K1: kernel vs plain pose {dpos} mm / {dang} rad, rmse {drm} mm")
    _require(abs(n_it - int(out_p[6])) <= 5, f"K1: iterations {n_it} vs {int(out_p[6])}")
    _require(float((pose_k[:2] - truth[:2]).norm()) < 30.0, "K1: did not recover the true pose")
    ms1 = _device_ms(torch, lambda: icp_fused(ds_xy, ds_valid, map_xy, map_valid, init, **kw), 20)
    plain1 = _device_ms(torch, lambda: icp_fused_plain(
        ds_xy, ds_valid, tgt_c, map_valid, params, iters=kw["iters"], thr2=kw["threshold_mm"] ** 2,
        tolerance=kw["tolerance"], anderson=False), 3)
    # the same registration against 256 targets: what a sweep costs besides the pairs
    small = (map_xy[:256].contiguous(), map_valid[:256].contiguous())
    it_small = int(icp_fused(ds_xy, ds_valid, *small, init, **kw)[3])
    sweep_small = _device_ms(torch, lambda: icp_fused(ds_xy, ds_valid, *small, init, **kw), 20) / (it_small + 1)
    n_src = int(ds_valid.sum())
    b1 = _bound(7.0 * n_src * n_map * (n_it + 1), n * 9 + cap * 9 + 16 + 32)
    kernels["icp_fused"] = dict(
        name="icp_fused", route="cuda", source="icp_slam_yolo_tpu_torch/csrc/icp.cu",
        replaces="icp_slam_yolo_tpu/ops/pallas/icp_fused.py:419", max_abs_err=max(dpos, drm),
        ms=ms1, plain_ms=plain1, bound_ms=b1[0], bound_by=b1[1], library_ms=None)
    print(f"[3] K1 icp_fused {n_src} live src x {n_map} live of {cap} tgt: pose err {dpos:.2g} mm / "
          f"{dang:.2g} rad, rmse err {drm:.2g} mm (tol 1 mm / 2e-3 rad / 1 mm), iters {n_it} vs "
          f"{int(out_p[6])}; device {ms1 * 1e3:.1f} us = {ms1 * 1e3 / (n_it + 1):.2f} us per sweep "
          f"({n_it} iterations + the final sweep), plain {plain1:.2f} ms; against 256 targets "
          f"{sweep_small * 1e3:.2f} us per sweep", flush=True)

    # K2: the raster, 512 rays, some blocked by an occupied wall
    h, w = cfg.map.height_px, cfg.map.width_px
    occ = torch.full((h, w), 0.5, dtype=torch.float32, device=dev)
    occ[h // 2 - 60: h // 2 + 60, w // 2 + 40: w // 2 + 43] = 0.9  # occupied wall in front
    robot = torch.tensor([150.0, -90.0], device=dev)
    pts = torch.tensor(rng.uniform(-5000, 5000, (n, 2)), dtype=torch.float32, device=dev)
    live = torch.tensor(rng.random(n) < 0.95, device=dev)
    win = cfg.occupancy.window_px
    rx, ry = world_to_px(robot, cfg.map)
    ex, ey = world_to_px(pts, cfg.map)
    inwin = ((ex >= torch.clamp(rx - win, min=0)) & (ex < torch.clamp(rx + win, max=w))
             & (ey >= torch.clamp(ry - win, min=0)) & (ey < torch.clamp(ry + win, max=h)))
    side_y, side_x = window_dims(h, w, cfg.occupancy)
    y0 = torch.clamp(ry - win, 0, h - side_y)
    x0 = torch.clamp(rx - win, 0, w - side_x)
    meta = torch.stack([y0, x0, ry - y0, rx - x0]).to(torch.int32)
    args2 = (occ, meta, (ey - y0).contiguous(), (ex - x0).contiguous(), (live & inwin).contiguous())
    kw2 = dict(side_y=side_y, side_x=side_x, k=cfg.occupancy.max_ray_px,
               p_occ_inc=cfg.occupancy.p_occ_inc, p_free_decay=cfg.occupancy.p_free_decay,
               block_threshold=cfg.occupancy.block_threshold)
    accept = torch.tensor(True, device=dev)
    g_k = raster_update(*args2, accept, **kw2)
    g_p = raster_update_plain(*args2, accept, **kw2)
    torch.cuda.synchronize()
    err2 = float((g_k - g_p).abs().max())
    _require(err2 <= 1e-6, f"K2: grid error {err2}")
    changed = int(((g_p - occ).abs() > 0).sum())
    _require(changed > 0 and float(g_k[h // 2, w // 2 + 50]) == 0.5,
             "K2: the wall did not shadow the cells behind it")
    prof2 = _device_profile(torch, lambda: raster_update(*args2, accept, **kw2), 200)
    ms2 = sum(prof2.values())
    plain2 = _device_ms(torch, lambda: raster_update_plain(*args2, accept, **kw2), 20)
    # what the step paid before K2 took the accept flag: a clone of the grid
    # for the kernel's output and a select over the grid on accept
    other = occ + 0.0
    clone_ms = _device_ms(torch, lambda: occ.clone(), 200)
    select_ms = _device_ms(torch, lambda: torch.where(accept, occ, other), 200)
    n_rays = int((live & inwin).sum())
    visits = n_rays * (win + 1)
    # the work the function needs: the window read and written once, the rays
    # and the flag; the full-grid copy is the wrapper's own overhead
    b2 = _bound(12.0 * visits + 20.0 * side_y * side_x, 2 * 4 * side_y * side_x + n * 9 + 16 + 1)
    kernels["raster_update"] = dict(
        name="raster_update", route="cuda", source="icp_slam_yolo_tpu_torch/csrc/raster.cu",
        replaces="icp_slam_yolo_tpu/ops/pallas/raster_fused.py:352", max_abs_err=err2,
        ms=ms2, plain_ms=plain2, bound_ms=b2[0], bound_by=b2[1], library_ms=None)
    parts = ", ".join(f"{k[:40]} {v * 1e3:.2f}" for k, v in sorted(prof2.items(), key=lambda kv: -kv[1]))
    print(f"[3] K2 raster_update {n_rays} rays, window {side_y}x{side_x} of {h}x{w}: max err "
          f"{err2:.2g} (tol 1e-6); device {ms2 * 1e3:.2f} us ({parts}), plain {plain2 * 1e3:.1f} us, "
          f"bound {b2[0] * 1e3:.3f} us; a full-grid clone {clone_ms * 1e3:.2f} us and select "
          f"{select_ms * 1e3:.2f} us (what the step no longer runs)", flush=True)

    return kernels


def check_edge_cases(cfg) -> int:
    """Phase 3, continued: each kernel against its plain version at the edges
    the main path can reach but the shapes above do not: ragged source and
    target counts, no valid target, no live source row, Anderson(1), a
    single ray, no ray, a window clamped at the grid's corner, and a
    rejected scan (accept false) that must leave the grid as it was.  Returns
    the number of cases."""
    import torch

    from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import _prepare, icp_fused, icp_fused_plain
    from icp_slam_yolo_tpu_torch.ops.pallas.nn_kernel import nn_argmin, nn_argmin_plain
    from icp_slam_yolo_tpu_torch.ops.pallas.raster_fused import raster_update, raster_update_plain
    from icp_slam_yolo_tpu_torch.ops.raster import window_dims

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    n_cases = 0

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    def mask(a):
        return torch.tensor(np.asarray(a), dtype=torch.bool, device=dev)

    for s, t, frac in ((1, 1, 1.0), (37, 1000, 0.5), (300, 1537, 0.9), (64, 300, 0.0)):
        src = f32(rng.uniform(-3000, 3000, (s, 2)))
        tgt = f32(np.round(rng.uniform(-3000, 3000, (t, 2)) / 200.0) * 200.0)  # coarse grid: ties
        tv = mask(rng.random(t) < frac)
        d_k, i_k = nn_argmin(src, tgt, tv)
        d_p, i_p = nn_argmin_plain(src, tgt, tv)
        _require(bool((i_k == i_p).all()) and bool((d_k == d_p).all()),
                 f"K3 edge case S={s} T={t} valid {frac}: kernel differs from plain")
        n_cases += 1

    room = warehouse_segments(4000.0, 3000.0)
    for s, t, frac_src, frac_tgt, anderson in ((40, 300, 1.0, 0.8, True), (300, 1000, 0.9, 0.9, False),
                                               (64, 256, 1.0, 0.0, False), (64, 256, 0.0, 1.0, False)):
        tgt_np = map_points_along(room, t, rng)
        src_np = map_points_along(room, s, rng, noise_mm=5.0) - np.array([60.0, -40.0])
        sv, tv = mask(rng.random(s) < frac_src), mask(rng.random(t) < frac_tgt)
        src, tgt, init = f32(src_np), f32(tgt_np), f32([20.0, -10.0, 0.01])
        kw = dict(iters=30, threshold_mm=cfg.icp.threshold_mm, tolerance=1e-3, anderson=anderson)
        pose_k, rmse_k, nin_k, it_k = icp_fused(src, sv, tgt, tv, init, **kw)
        params, tgt_c, c = _prepare(tgt, tv, init)
        out_p = icp_fused_plain(src, sv, tgt_c, tv, params, iters=30, thr2=kw["threshold_mm"] ** 2,
                                tolerance=1e-3, anderson=anderson)
        pose_p = torch.stack([out_p[0] + c[0], out_p[1] + c[1], torch.atan2(out_p[3], out_p[2])])
        rmse_p = float(out_p[4]) if float(out_p[4]) < 1e30 else float("inf")
        ok = (float((pose_k[:2] - pose_p[:2]).abs().max()) <= 1.0
              and float((pose_k[2] - pose_p[2]).abs()) <= 2e-3
              and abs(int(nin_k) - int(out_p[5])) <= 2
              and (abs(float(rmse_k) - rmse_p) <= 1.0 if np.isfinite(rmse_p) else not np.isfinite(float(rmse_k))))
        _require(ok, f"K1 edge case S={s} T={t} src {frac_src} tgt {frac_tgt} anderson {anderson}: "
                     f"kernel {pose_k.tolist()} {float(rmse_k)} vs plain {pose_p.tolist()} {rmse_p}")
        n_cases += 1

    h, w = cfg.map.height_px, cfg.map.width_px
    side_y, side_x = window_dims(h, w, cfg.occupancy)
    occ = f32(rng.uniform(0.0, 1.0, (h, w)))  # many cells above the block threshold
    kw2 = dict(side_y=side_y, side_x=side_x, k=cfg.occupancy.max_ray_px, p_occ_inc=cfg.occupancy.p_occ_inc,
               p_free_decay=cfg.occupancy.p_free_decay, block_threshold=cfg.occupancy.block_threshold)
    win = cfg.occupancy.window_px
    for n, (ry, rx) in ((1, (400, 500)), (0, (400, 500)), (333, (3, 5)), (512, (h - 2, w - 1))):
        y0, x0 = min(max(ry - win, 0), h - side_y), min(max(rx - win, 0), w - side_x)
        meta = torch.tensor([y0, x0, ry - y0, rx - x0], dtype=torch.int32, device=dev)
        ey = torch.tensor(rng.integers(max(ry - win, 0), min(ry + win, h), n) - y0, dtype=torch.int32, device=dev)
        ex = torch.tensor(rng.integers(max(rx - win, 0), min(rx + win, w), n) - x0, dtype=torch.int32, device=dev)
        live = mask(rng.random(n) < 0.9)
        for acc in (None, mask(True), mask(False)):
            g_k = raster_update(occ, meta, ey, ex, live, acc, **kw2)
            err = float((g_k - raster_update_plain(occ, meta, ey, ex, live, acc, **kw2)).abs().max())
            _require(err <= 1e-6, f"K2 edge case {n} rays, robot cell ({ry}, {rx}), accept {acc}: "
                                  f"grid error {err}")
            _require(acc is None or bool(acc) or torch.equal(g_k, occ),
                     "K2: a rejected scan changed the grid")
            n_cases += 1
    torch.cuda.synchronize()
    print(f"[3] edge cases: {n_cases} cases, every kernel equal to its plain version within the "
          f"tolerances above", flush=True)
    return n_cases


def replay(cfg, n_scans: int = 300, n_cpu: int = 12) -> tuple[dict, float]:
    """Phase 4: ``Slam(cfg).run`` on the card over a synthetic warehouse with
    the launch counters reset just before and read just after, checked
    against ground truth; then the first ``n_cpu`` scans on the CPU (plain
    versions) against the card's run.  Returns ``(launches, scans/s)``."""
    import torch

    import icp_slam_yolo_tpu_torch as port
    from icp_slam_yolo_tpu_torch.ops import pallas

    cap, h, w = cfg.map_capacity, cfg.map.height_px, cfg.map.width_px
    scans, gt = synthetic_sequence(n_scans, seed=7)
    padded = np.zeros((n_scans, cfg.n_max, 3), np.float32)
    padded[:, : scans.shape[1]] = scans
    port.Slam(cfg).run(padded[:4])  # warm-up: CUDA context and caching allocator
    torch.cuda.synchronize()
    pallas.reset_launches()
    t0 = time.perf_counter()
    slam = port.Slam(cfg)
    state, outs = slam.run(padded)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(pallas.LAUNCHES)
    acc = outs.accepted.cpu().numpy()
    rmse = outs.rmse.cpu().numpy()
    poses = outs.pose.cpu().numpy()
    rel = relative_poses(gt)[1:]
    pos_err = np.hypot(poses[:, 0] - rel[:, 0], poses[:, 1] - rel[:, 1])
    ang_err = np.abs(np.arctan2(np.sin(poses[:, 2] - rel[:, 2]), np.cos(poses[:, 2] - rel[:, 2])))
    n_map_pts = int(state.map_valid.sum())
    print(f"[4] replay {n_scans} scans at full width (n_max {cfg.n_max}, map {cap}, grid {h}x{w}): "
          f"{n_scans / secs:.1f} scans/s; accepted {acc.mean():.4f}; median rmse "
          f"{np.median(rmse[acc]):.2f} mm; trajectory error max {pos_err.max():.1f} mm, final "
          f"{pos_err[-1]:.1f} mm over {np.hypot(*np.diff(gt[:, :2], axis=0).T).sum() / 1e3:.1f} m, "
          f"heading max {ang_err.max():.4f} rad; map points {n_map_pts}; "
          f"launches {launches}", flush=True)
    for name, count in launches.items():
        _require(count > 0, f"main path never launched {name}")
    _require(np.isfinite(poses).all(), "non-finite poses")
    _require(acc.mean() >= 0.95, f"acceptance {acc.mean()}")
    _require(np.median(rmse[acc]) < cfg.icp.max_rmse, "median rmse above the gate")
    # scan-to-map odometry drifts; allow 2 % of the distance travelled + 0.15 m
    travelled = np.concatenate([[0.0], np.cumsum(np.hypot(*np.diff(gt[:, :2], axis=0).T))])[1:]
    _require(bool((pos_err < 0.02 * travelled + 150.0).all()) and ang_err.max() < 0.05,
             "trajectory drifted from ground truth")
    _require(0 < n_map_pts <= cap, "map count out of range")
    occ_np = state.occ.cpu().numpy()
    _require(occ_np.min() >= 0.0 and occ_np.max() <= 1.0 and (occ_np != 0.5).sum() > 1000,
             "occupancy grid not painted or out of [0, 1]")

    # the step enqueues its work without waiting for the card: PyTorch's sync
    # debug mode raises on each synchronising call it detects
    from icp_slam_yolo_tpu_torch.slam import pipeline

    scans_dev = torch.from_numpy(padded[:6]).to("cuda")
    step = pipeline.make_step(cfg)
    st = pipeline.init_state(scans_dev[0], cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(1, 6):
            st, _ = step(st, scans_dev[t])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("[4] 5 steps under torch.cuda.set_sync_debug_mode('error'): no host synchronisation", flush=True)

    # where the device time of a step goes, over a short window under the profiler
    from torch.profiler import ProfilerActivity, profile

    n_win = 21
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        port.Slam(cfg).run(padded[:n_win])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = sorted(_kernel_events(torch, prof), key=lambda e: -e.self_device_time_total)
    dev_us = sum(e.self_device_time_total for e in avgs)
    top = "; ".join(f"{e.key[:48]} {e.self_device_time_total / (n_win - 1):.1f}" for e in avgs[:6])
    n_launch = sum(e.count for e in avgs)
    print(f"[4] profiled {n_win - 1} steps: device busy {dev_us / 1e6 / wall:.3f} of wall "
          f"(profiler on), device {dev_us / (n_win - 1):.1f} us/step, {n_launch / (n_win - 1):.0f} "
          f"device launches/step; top kernels us/step: {top}", flush=True)

    t0 = time.perf_counter()
    _, outs_cpu = port.run_sequence(padded[:n_cpu], cfg, device="cpu")
    cpu_secs = time.perf_counter() - t0
    acc_c = outs_cpu.accepted.numpy()
    dpose = np.abs(outs_cpu.pose.numpy() - poses[: n_cpu - 1])
    print(f"[4] cpu replay of {n_cpu} scans ({cpu_secs:.1f} s): accept flags equal "
          f"{bool((acc_c == acc[: n_cpu - 1]).all())}, max pose diff {dpose[:, :2].max():.3g} mm / "
          f"{dpose[:, 2].max():.3g} rad (tol 2 mm / 2e-3 rad)", flush=True)
    _require(bool((acc_c == acc[: n_cpu - 1]).all()), "cpu and card accept flags differ")
    _require(dpose[:, :2].max() <= 2.0 and dpose[:, 2].max() <= 2e-3, "cpu and card poses differ")

    return launches, n_scans / secs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from icp_slam_yolo_tpu_torch.ops.pallas import _lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=False,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(f"[1] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _lib.lib()
    print(f"[2] built kernels in {time.perf_counter() - t0:.1f} s", flush=True)

    cfg = slice_config()
    kernels = check_kernels(cfg)
    check_edge_cases(cfg)
    launches, _ = replay(cfg)

    rows = []
    for name in ("icp_fused", "raster_update", "nn_argmin"):
        row = kernels[name]
        row["launches"] = launches[name]
        rows.append({k: row[k] for k in ("name", "route", "source", "replaces", "launches", "max_abs_err",
                                         "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
