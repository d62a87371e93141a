"""Seeded synthetic warehouse scans: the walls of a hall with rack rows and
pillars, a loop path around the central row, and 2-D LiDAR scans ray-cast
from each pose.  They stand in for recorded scans wherever none are given:
`cli bench`, `chip_smoke.py` and the CPU tests replay them.  Numpy only.
"""

from __future__ import annotations

import numpy as np


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
