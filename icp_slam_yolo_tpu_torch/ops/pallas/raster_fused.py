"""K2 and K4: one scan's occupancy update inside the window around the robot.

Counterparts of the JAX package's ``raster_update_pallas`` (K2, the window
variant the default 833 x 1000 grid takes) and ``raster_update_grid_pallas``
(K4, the full-grid variant with its grid aliased to its output, batched over
the fleet's robot axis; both in ``ops/pallas/raster_fused.py``).  The CUDA kernels are in
``csrc/raster.cu``; the source says what bounds them and how they are laid
out.

All versions take the FULL grids ``(B, H, W)`` plus ``meta (B, 4) = [y0, x0,
rly, rlx]`` per robot (window origin in the grid, robot cell in the window)
and optional ``accept (B,)`` flags as device tensors, so the caller never
reads them on the host.  Cells outside a robot's ``(side_y, side_x)`` window,
and every cell of a robot whose flag is false, keep their values.  K2
(`raster_update`) returns new grids; K4 (`raster_update_grid`) updates the
caller's grids IN PLACE and returns the same tensor, as the TPU kernel does
through its aliased output.  Both take grids of any shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.pallas import _lib


class RayCells(NamedTuple):
    px: torch.Tensor        # (..., N, K) int32 cell x per sample
    py: torch.Tensor        # (..., N, K) int32 cell y per sample
    body: torch.Tensor      # (..., N, K) bool: body sample (i < L) of a valid ray
    endpoint: torch.Tensor  # (..., N, K) bool: endpoint sample (i == L) of a valid ray


def bresenham_cells(x0, y0, x1: torch.Tensor, y1: torch.Tensor, ray_valid: torch.Tensor, k: int) -> RayCells:
    """Closed-form Bresenham samples ``i in [0, k)`` for ``(..., N)`` rays
    from ``(x0, y0)`` (scalars, or ``(..., 1)`` per batch row) to
    ``(x1, y1)``: on the driving axis step ``i`` the minor
    coordinate moves ``max(0, ceil((2 i d_minor - d_major) / (2 d_major)))``
    cells — the reference's error-accumulator sequence, with its tie-break
    (x-driven iff ``dx > dy``) and the endpoint at ``i == L = max(dx, dy)``.
    """
    dx = torch.abs(x1 - x0)
    dy = torch.abs(y1 - y0)
    one = torch.ones_like(dx)
    sx = torch.where(x1 >= x0, one, -one)[..., None]
    sy = torch.where(y1 >= y0, one, -one)[..., None]
    ell = torch.maximum(dx, dy)[..., None]
    i = torch.arange(k, dtype=torch.int32, device=x1.device)
    dxe, dye = dx[..., None], dy[..., None]
    x0, y0 = x0[..., None], y0[..., None]

    def minor_steps(d_minor, d_major):
        a = 2 * i * d_minor - d_major
        b = 2 * torch.clamp(d_major, min=1)
        return torch.clamp(-torch.div(-a, b, rounding_mode="floor"), min=0)

    x_driven = dxe > dye
    kx = minor_steps(dye, dxe)  # y-steps when x-driven
    ky = minor_steps(dxe, dye)  # x-steps when y-driven
    px = torch.where(x_driven, x0 + sx * i, x0 + sx * ky)
    py = torch.where(x_driven, y0 + sy * kx, y0 + sy * i)
    in_ray = (i <= ell) & ray_valid[..., None]
    return RayCells(px=px, py=py, body=in_ray & (i < ell), endpoint=in_ray & (i == ell))


def raster_update_plain(occ, meta, ey, ex, live, accept=None, *, side_y: int, side_x: int, k: int,
                        p_occ_inc: float, p_free_decay: float, block_threshold: float):
    """Plain version of both kernels (same arguments); returns new grids."""
    b, h, w = occ.shape
    dev = occ.device
    y0, x0 = meta[:, 0:1].long(), meta[:, 1:2].long()  # (B, 1)
    cells = bresenham_cells(meta[:, 3:4], meta[:, 2:3], ex, ey, live, k)
    in_win = (cells.py >= 0) & (cells.py < side_y) & (cells.px >= 0) & (cells.px < side_x)
    body = cells.body & in_win
    end = cells.endpoint & in_win
    ly = torch.clamp(cells.py, 0, side_y - 1).long()
    lx = torch.clamp(cells.px, 0, side_x - 1).long()
    flat = occ.reshape(b, -1)
    # frozen scan-start probabilities: the first blocked body cell ends the ray
    gidx = ((y0[..., None] + ly) * w + (x0[..., None] + lx)).reshape(b, -1)
    blocked = body & (torch.gather(flat, 1, gidx).reshape(body.shape) >= block_threshold)
    i = torch.arange(k, device=dev)
    first = torch.where(blocked, i, torch.full_like(i, k)).min(dim=-1, keepdim=True).values
    free = body & (i < first)
    end = end & (first == k)
    local = (ly * side_x + lx).reshape(b, -1)
    zeros = torch.zeros((b, side_y * side_x), dtype=torch.float32, device=dev)
    n_free = zeros.scatter_add(1, local, free.reshape(b, -1).to(torch.float32))
    n_end = zeros.scatter_add(1, local, end.reshape(b, -1).to(torch.float32))
    wy = torch.arange(side_y, device=dev)[:, None]
    wx = torch.arange(side_x, device=dev)[None, :]
    widx = ((y0[..., None] + wy) * w + (x0[..., None] + wx)).reshape(b, -1)
    old = torch.gather(flat, 1, widx)
    p = old * torch.pow(torch.tensor(p_free_decay, dtype=torch.float32, device=dev), n_free)
    p = torch.clamp(p + p_occ_inc * n_end, max=1.0)
    if accept is not None:
        p = torch.where(accept[:, None], p, old)
    return flat.scatter(1, widx, p).reshape(occ.shape)


def raster_update_grid_plain(occ, meta, ey, ex, live, accept=None, **kw):
    """Plain version of K4: `raster_update_plain`, written back into ``occ``
    (in place, as the kernel) and returned."""
    return occ.copy_(raster_update_plain(occ, meta, ey, ex, live, accept, **kw))


def _check(occ, meta, ey, ex, live, accept, side_y, side_x):
    dev = occ.device
    if occ.dim() != 3:
        raise ValueError(f"occ: shape {tuple(occ.shape)}, expected (B, H, W)")
    b, h, w = occ.shape
    n = ey.shape[-1]
    pallas.check_tensor(occ, "occ", torch.float32, (b, h, w), dev)
    pallas.check_tensor(meta, "meta", torch.int32, (b, 4), dev)
    pallas.check_tensor(ey, "ey", torch.int32, (b, n), dev)
    pallas.check_tensor(ex, "ex", torch.int32, (b, n), dev)
    pallas.check_tensor(live, "live", torch.bool, (b, n), dev)
    if accept is not None:
        pallas.check_tensor(accept, "accept", torch.bool, (b,), dev)
    if not (0 < side_y <= h and 0 < side_x <= w):
        raise ValueError(f"window {side_y}x{side_x} does not fit the grid {h}x{w}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"raster update: unsupported device {dev}")


def _launch(entry: str, grids: tuple, occ, meta, ey, ex, live, accept, kw) -> None:
    """Launch one of the two C entry points on ``grids`` (the data pointers
    that lead its arguments) with a zeroed counts scratch."""
    b, h, w = occ.shape
    counts = torch.zeros((b, 2, kw["side_y"], kw["side_x"]), dtype=torch.int32, device=occ.device)
    err = getattr(_lib.lib(), entry)(
        *grids, b, h, w, meta.data_ptr(), ey.data_ptr(), ex.data_ptr(), live.data_ptr(),
        None if accept is None else accept.data_ptr(), ey.shape[1], kw["side_y"], kw["side_x"], int(kw["k"]),
        float(kw["block_threshold"]), float(kw["p_free_decay"]), float(kw["p_occ_inc"]),
        counts.data_ptr(), _lib.stream_ptr(occ.device),
    )
    _lib.check(err, entry)


def raster_update(occ, meta, ey, ex, live, accept=None, *, side_y: int, side_x: int, k: int,
                  p_occ_inc: float, p_free_decay: float, block_threshold: float):
    """K2: one scan's occupancy update per robot, into new grids.

    Args:
      occ: ``(B, H, W)`` f32 probability grids (not modified).
      meta: ``(B, 4)`` int32 ``[y0, x0, rly, rlx]``; each window
        ``[y0, y0 + side_y) x [x0, x0 + side_x)`` must lie inside the grid.
      ey/ex: ``(B, N)`` int32 window-local endpoint cells; live: ``(B, N)`` bool.
      accept: ``(B,)`` bool, or ``None`` for always: a robot's window is
        updated only where its flag is true (the SLAM step's accept flag,
        kept on the device so the step needs no select over the grid).
      k: samples per ray (``> window_px``).

    Returns the updated grids.  Launches the CUDA kernel for CUDA tensors;
    the plain version runs only for CPU tensors.
    """
    kw = dict(side_y=side_y, side_x=side_x, k=k, p_occ_inc=p_occ_inc,
              p_free_decay=p_free_decay, block_threshold=block_threshold)
    _check(occ, meta, ey, ex, live, accept, side_y, side_x)
    if occ.device.type == "cpu":
        return raster_update_plain(occ, meta, ey, ex, live, accept, **kw)
    out = torch.empty_like(occ)  # the kernel writes every cell
    _launch("slam_raster_update", (occ.data_ptr(), out.data_ptr()), occ, meta, ey, ex, live, accept, kw)
    pallas.LAUNCHES["raster_update"] += 1
    return out


def raster_update_grid(occ, meta, ey, ex, live, accept=None, *, side_y: int, side_x: int, k: int,
                       p_occ_inc: float, p_free_decay: float, block_threshold: float):
    """K4: one scan's occupancy update per robot, IN PLACE.

    Arguments as `raster_update`.  The
    caller owns ``occ``: the windows are written into it and the same tensor
    is returned, so no cell outside a window moves through memory.  Launches
    the CUDA kernel for CUDA tensors; the plain version runs only for CPU
    tensors.
    """
    _check(occ, meta, ey, ex, live, accept, side_y, side_x)
    kw = dict(side_y=side_y, side_x=side_x, k=k, p_occ_inc=p_occ_inc,
              p_free_decay=p_free_decay, block_threshold=block_threshold)
    if occ.device.type == "cpu":
        return raster_update_grid_plain(occ, meta, ey, ex, live, accept, **kw)
    _launch("slam_raster_update_grid", (occ.data_ptr(),), occ, meta, ey, ex, live, accept, kw)
    pallas.LAUNCHES["raster_update_grid"] += 1
    return occ
