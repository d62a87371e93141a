"""Occupancy grid: pixel mapping, the per-scan raster update and map pruning.

Counterpart of the JAX package's ``ops/raster.py``.  The update follows the
reference's frozen-probability semantics (`process.py:114-179`): each ray
stops at its first body cell already ``>= block_threshold`` at scan start;
per cell ``p *= decay^n_free`` then ``p = min(1, p + inc * n_end)``.  It runs
through K2 or K4 (`ops/pallas/raster_fused`), chosen by who owns the grid
(see `update_occupancy`).  The JAX package's one-hot MXU lookups are TPU
workarounds; here lookups are plain indexing.  Every function keeps static
shapes and never reads a tensor on the host.  `update_occupancy` takes a
leading robot axis: grids ``(B, H, W)``, points ``(B, N, 2)``, robot
positions ``(B, 2)``; the pixel mapping and the keep-masks carry any leading
axes through.
"""

from __future__ import annotations

import torch

from icp_slam_yolo_tpu_torch.config import MapConfig, OccupancyConfig
from icp_slam_yolo_tpu_torch.ops.pallas.raster_fused import (  # noqa: F401  (re-export)
    RayCells,
    bresenham_cells,
    raster_update,
    raster_update_grid,
)


def world_to_px(xy: torch.Tensor, map_cfg: MapConfig):
    """World mm -> int32 pixel: ``px = cx + x/res``, ``py = cy - y/res``,
    truncated toward zero like the reference's ``int()``."""
    cx, cy = map_cfg.center_px
    res = float(map_cfg.resolution_mm_per_px)
    px = torch.trunc(cx + xy[..., 0] / res).to(torch.int32)
    py = torch.trunc(cy - xy[..., 1] / res).to(torch.int32)
    return px, py


def window_dims(h: int, w: int, occ_cfg: OccupancyConfig) -> tuple[int, int]:
    """Update-window side: ``2 * window_px`` rounded up to 128 (384 at the
    default 140 px), capped by the grid.  Any window that contains
    ``[r - window_px, r + window_px)`` gives the same grid."""
    side = -(-2 * occ_cfg.window_px // 128) * 128
    return min(side, h), min(side, w)


def update_occupancy(occ: torch.Tensor, points_xy: torch.Tensor, valid: torch.Tensor,
                     robot_xy: torch.Tensor, map_cfg: MapConfig,
                     occ_cfg: OccupancyConfig, accept: torch.Tensor | None = None,
                     *, in_place: bool = False) -> torch.Tensor:
    """One scan's occupancy update per robot, ``(B, H, W)`` grids of any
    shape; ``accept`` (``(B,)`` bool, ``None``: always) keeps a robot's grid
    where it is false.

    Ownership picks the kernel, in this one place.  ``in_place=False``: K2,
    ``occ`` is left as it was and new grids come back.  ``in_place=True``: the
    caller owns ``occ`` and gives it up: K4 writes the windows INTO it and
    returns the same tensor, so no cell outside a window moves through memory.
    Only the fleet step asks for that (`slam/pipeline.make_batched_step`).

    A ray is dropped when its endpoint cell lies outside
    ``[max(0, r - win), min(dim, r + win))`` on either axis; the window
    origin is ``clip(r - win, 0, dim - side)``.
    """
    if occ_cfg.backend not in ("auto", "fused"):
        raise NotImplementedError(
            f"OccupancyConfig.backend={occ_cfg.backend!r}: the port has one raster, "
            "K2/K4 (backend 'auto' or 'fused')"
        )
    h, w = occ.shape[-2:]
    win = occ_cfg.window_px
    rx, ry = world_to_px(robot_xy, map_cfg)  # (B,)
    ex, ey = world_to_px(points_xy, map_cfg)  # (B, N)
    rxe, rye = rx[:, None], ry[:, None]
    in_window = (
        (ex >= torch.clamp(rxe - win, min=0)) & (ex < torch.clamp(rxe + win, max=w))
        & (ey >= torch.clamp(rye - win, min=0)) & (ey < torch.clamp(rye + win, max=h))
    )
    side_y, side_x = window_dims(h, w, occ_cfg)
    y0 = torch.clamp(ry - win, 0, h - side_y)
    x0 = torch.clamp(rx - win, 0, w - side_x)
    meta = torch.stack([y0, x0, ry - y0, rx - x0], dim=1).to(torch.int32)
    update = raster_update_grid if in_place else raster_update
    return update(
        occ, meta, (ey - y0[:, None]).contiguous(), (ex - x0[:, None]).contiguous(),
        (valid & in_window).contiguous(), accept,
        side_y=side_y, side_x=side_x, k=occ_cfg.max_ray_px, p_occ_inc=occ_cfg.p_occ_inc,
        p_free_decay=occ_cfg.p_free_decay, block_threshold=occ_cfg.block_threshold,
    )


def _lookup(occ: torch.Tensor, px: torch.Tensor, py: torch.Tensor, threshold: float) -> torch.Tensor:
    """``occ[..., py, px] >= threshold`` with coordinates clamped onto the grid."""
    h, w = occ.shape[-2:]
    idx = torch.clamp(py, 0, h - 1).long() * w + torch.clamp(px, 0, w - 1).long()
    return torch.gather(occ.reshape(*occ.shape[:-2], h * w), -1, idx) >= threshold


def occupancy_keep_mask(points_xy: torch.Tensor, valid: torch.Tensor, occ: torch.Tensor,
                        map_cfg: MapConfig, free_threshold: float) -> torch.Tensor:
    """Drop points whose cell is confidently free (``p < free_threshold``);
    points off the grid are kept (`process.py:203-249`)."""
    h, w = occ.shape[-2:]
    px, py = world_to_px(points_xy, map_cfg)
    oob = (px < 0) | (px >= w) | (py < 0) | (py >= h)
    return valid & (oob | _lookup(occ, px, py, free_threshold))


def prune_keep_mask(points_xy: torch.Tensor, valid: torch.Tensor, occ: torch.Tensor,
                    robot_xy: torch.Tensor, map_cfg: MapConfig,
                    occ_cfg: OccupancyConfig) -> torch.Tensor:
    """Keep-mask of the map prune.  ``prune_window_margin_px < 0``: the full
    grid check.  Otherwise only points inside the raster window grown by the
    margin are checked; outside it no cell changed since the last prune, so
    the earlier decision (the point's presence) stands."""
    margin = occ_cfg.prune_window_margin_px
    if margin < 0:
        return occupancy_keep_mask(points_xy, valid, occ, map_cfg, occ_cfg.free_threshold)
    h, w = occ.shape[-2:]
    win = occ_cfg.window_px + margin
    ww, wh = min(2 * win, w), min(2 * win, h)
    rx, ry = world_to_px(robot_xy, map_cfg)
    x1s = torch.clamp(rx - win, 0, w - ww)[..., None]
    y1s = torch.clamp(ry - win, 0, h - wh)[..., None]
    px, py = world_to_px(points_xy, map_cfg)
    inside = (px >= x1s) & (px < x1s + ww) & (py >= y1s) & (py < y1s + wh)
    return valid & (~inside | _lookup(occ, px, py, occ_cfg.free_threshold))
