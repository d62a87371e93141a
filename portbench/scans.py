"""Seeded synthetic warehouse scans for many robots, ray-cast on the card.

The benchmark's own copy of the program's generator (the walls of a hall
with rack rows and pillars, a loop path around the central row, 2-D LiDAR
scans ray-cast from each pose), vectorised over robots and scans so that
set-up stays short: the walls and the poses are the same numbers, the
ranges are cast in float64 on the card, and the noise, dropouts and return
qualities have the same laws but come from a ``torch.Generator`` on the
card, drawn in a few large calls.

A traffic file gives the hall, the number of robots, the range of scans a
lap takes (each robot's step length divides the loop exactly, so its stream
repeats without a jump) and whether the robots start spread along the loop
(independent robots) or all at one pose (a depot sharing one map).  Every
seed gets the same set of laps and start phases; the seed permutes which
robot takes which, and draws the noise.  Where the traffic file gives a
``noise_seed``, every lap's noise comes from it instead, drawn for the laps
in their unpermuted order: every seed then gets the same set of streams,
noise included, and permutes which robot runs which.
"""

from __future__ import annotations

import numpy as np
import torch


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


def _legs(half_x, half_y, radius):
    arc = 0.5 * np.pi * radius
    return [2 * (half_x - radius), arc, 2 * (half_y - radius), arc] * 2


def loop_length(half_x: float, half_y: float, radius: float) -> float:
    return float(sum(_legs(half_x, half_y, radius)))


def _advance(x, y, th, leg, s, radius):
    if leg % 2 == 0:  # straight
        return x + s * np.cos(th), y + s * np.sin(th), th
    a = s / radius  # left turn about the centre on the left of the heading
    cx, cy = x - radius * np.sin(th), y + radius * np.cos(th)
    th2 = th + a
    return cx + radius * np.sin(th2), cy - radius * np.cos(th2), th2


def loop_path(n: int, half_x: float, half_y: float, radius: float, step_mm: float, start: int = 0) -> np.ndarray:
    """Ground-truth poses ``(n, 3)`` at arc lengths ``(start + k) step_mm``
    (k < n) along a rounded rectangle around the central rack row, heading
    along the path; the walk starts at the bottom straight's left end."""
    legs = _legs(half_x, half_y, radius)
    total = float(sum(legs))
    starts = [(-half_x + radius, -half_y, 0.0)]
    for leg, length in enumerate(legs[:-1]):
        starts.append(_advance(*starts[-1], leg, length, radius))
    s = ((start + np.arange(n)) * step_mm) % total
    ends = np.cumsum(legs)
    leg = np.minimum(np.searchsorted(ends, s, side="left"), len(legs) - 1)
    s = s - np.concatenate([[0.0], ends[:-1]])[leg]
    out = np.empty((n, 3))
    for k in range(len(legs)):
        m = leg == k
        if m.any():
            x0, y0, th0 = starts[k]
            out[m] = np.stack(_advance(np.full(m.sum(), x0), np.full(m.sum(), y0), np.full(m.sum(), th0),
                                       k, s[m], radius), axis=1)
    return out


def raycast(poses: torch.Tensor, segs: torch.Tensor, angles_deg: torch.Tensor, y_sign: float = -1.0,
            chunk: int = 1024) -> torch.Tensor:
    """Range (mm) to the nearest wall along each beam of each pose, ``(P,
    beams)`` float64; ``inf`` for no hit.  A beam at angle ``a`` points along
    ``(cos a, y_sign sin a)`` in the sensor frame."""
    a = torch.deg2rad(angles_deg.to(torch.float64))
    lx, ly = torch.cos(a), y_sign * torch.sin(a)
    ax0, ay0 = segs[:, 0], segs[:, 1]
    ex, ey = segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1]
    out = []
    for p in poses.to(torch.float64).split(chunk):
        x, y, th = p[:, 0:1], p[:, 1:2], p[:, 2:3]
        dx = torch.cos(th) * lx - torch.sin(th) * ly  # (P, beams)
        dy = torch.sin(th) * lx + torch.cos(th) * ly
        ax, ay = (ax0 - x)[:, None, :], (ay0 - y)[:, None, :]  # (P, 1, M)
        den = dx[..., None] * ey - dy[..., None] * ex
        safe = torch.where(den.abs() > 1e-9, den, torch.ones_like(den))
        t = (ax * ey - ay * ex) / safe
        u = (ax * dy[..., None] - ay * dx[..., None]) / safe
        hit = (den.abs() > 1e-9) & (t > 1.0) & (u >= 0.0) & (u <= 1.0)
        out.append(torch.where(hit, t, torch.full_like(t, float("inf"))).min(dim=-1).values)
    return torch.cat(out)


def robot_plan(traffic: dict, seed: int):
    """Each robot's scans a lap and start phase, and which stream it runs:
    ``(laps (R,), phases (R,), streams (R,))`` ints.  The laps are spread
    evenly over the traffic's range and the phases evenly over the loop
    ('spread') or all 0 ('depot'); the seed permutes which robot takes
    which (robot ``i`` runs lap ``streams[i]`` of the unpermuted range)."""
    r = int(traffic["robots"])
    lo, hi = traffic["scans_a_lap"]
    laps = np.rint(np.linspace(lo, hi, r)).astype(np.int64)
    rng = np.random.default_rng(seed)
    streams = rng.permutation(r)
    laps = laps[streams]
    if traffic["start"] == "spread":
        phases = (np.arange(r) * laps.min()) // r
        phases = phases[rng.permutation(r)]
    elif traffic["start"] == "depot":
        phases = np.zeros(r, np.int64)
    else:
        raise ValueError(f"unknown start {traffic['start']!r}")
    return laps, phases, streams


def fleet_streams(traffic: dict, seed: int, n_max: int, device) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Every robot's lap of scans: ``(scans (R, L, n_max, 3) float32 on
    device, laps (R,), ground truth (R, L, 3))`` with ``L`` the longest lap;
    robot ``r``'s scan at step ``t`` is ``scans[r, t % laps[r]]``.  Rows are
    ``[quality, angle_deg, distance_mm]``; beams with no return within range
    and dropouts are all-zero rows, as are the pad rows beyond the beams."""
    hall = traffic["hall"]
    laps, phases, streams = robot_plan(traffic, seed)
    total = loop_length(hall["path_half_x"], hall["path_half_y"], hall["radius"])
    r, big = len(laps), int(laps.max())
    gt = np.zeros((r, big, 3))
    for i, (lap, phase) in enumerate(zip(laps, phases)):
        gt[i] = loop_path(big, hall["path_half_x"], hall["path_half_y"], hall["radius"], total / lap, int(phase))
    beams = int(traffic["beams"])
    if beams > n_max:
        raise ValueError(f"{beams} beams do not fit n_max {n_max}")
    segs = torch.as_tensor(warehouse_segments(hall["half_x"], hall["half_y"]), device=device)
    angles = torch.arange(beams, dtype=torch.float64, device=device) * (360.0 / beams)
    ranges = raycast(torch.as_tensor(gt.reshape(-1, 3), device=device), segs, angles).reshape(r, big, beams)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(traffic.get("noise_seed", seed)) % 2**63)
    noise = torch.randn((r, big, beams), generator=gen, device=device, dtype=torch.float64)
    keep = torch.rand((r, big, beams), generator=gen, device=device, dtype=torch.float64)
    quality = torch.randint(0, 40, (r, big, beams), generator=gen, device=device)
    if "noise_seed" in traffic:
        order = torch.as_tensor(streams, device=device)
        noise, keep, quality = noise[order], keep[order], quality[order]
    rng_mm = ranges + float(traffic["noise_mm"]) * noise
    ok = torch.isfinite(rng_mm) & (rng_mm < float(traffic["max_range_mm"])) & (keep >= float(traffic["dropout"]))
    scans = torch.zeros((r, big, n_max, 3), dtype=torch.float32, device=device)
    scans[..., :beams, 0] = torch.where(ok, 15.0 + quality.to(torch.float64), 0.0).to(torch.float32)
    scans[..., :beams, 1] = angles.to(torch.float32)
    scans[..., :beams, 2] = torch.where(ok, rng_mm, 0.0).to(torch.float32)
    return scans, laps, gt


class Feed:
    """The scans of step ``t`` for every robot, ``(R, n_max, 3)``: one gather
    from a table of flat row indices made once on the card."""

    def __init__(self, scans: torch.Tensor, laps: np.ndarray, steps: int):
        r, big = scans.shape[:2]
        self.flat = scans.reshape(r * big, *scans.shape[2:])
        t = np.arange(steps)[:, None]
        rows = np.arange(r)[None, :] * big + t % laps[None, :]
        self.rows = torch.as_tensor(rows, device=scans.device)
        self.steps = steps

    def __call__(self, t: int) -> torch.Tensor:
        return self.flat[self.rows[t % self.steps]]
