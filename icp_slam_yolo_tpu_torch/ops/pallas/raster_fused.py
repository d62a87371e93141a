"""K2: one scan's occupancy update inside the window around the robot.

Counterpart of the JAX package's ``raster_update_pallas``
(``ops/pallas/raster_fused.py``, the window variant the default 833 x 1000
grid takes).  The CUDA kernel is ``csrc/raster.cu``; its source says what
bounds it and how it is laid out.

Both versions take the FULL grid plus ``meta = [y0, x0, rly, rlx]`` (window
origin in the grid, robot cell in the window) and an optional ``accept``
flag as device tensors, so the caller never reads them on the host, and
return a new grid whose cells outside the ``(side_y, side_x)`` window, and
all cells where ``accept`` is false, are copies of the input's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.pallas import _lib


class RayCells(NamedTuple):
    px: torch.Tensor        # (N, K) int32 cell x per sample
    py: torch.Tensor        # (N, K) int32 cell y per sample
    body: torch.Tensor      # (N, K) bool: body sample (i < L) of a valid ray
    endpoint: torch.Tensor  # (N, K) bool: endpoint sample (i == L) of a valid ray


def bresenham_cells(x0, y0, x1: torch.Tensor, y1: torch.Tensor, ray_valid: torch.Tensor, k: int) -> RayCells:
    """Closed-form Bresenham samples ``i in [0, k)`` for N rays from
    ``(x0, y0)`` to ``(x1, y1)``: on the driving axis step ``i`` the minor
    coordinate moves ``max(0, ceil((2 i d_minor - d_major) / (2 d_major)))``
    cells — the reference's error-accumulator sequence, with its tie-break
    (x-driven iff ``dx > dy``) and the endpoint at ``i == L = max(dx, dy)``.
    """
    dx = torch.abs(x1 - x0)
    dy = torch.abs(y1 - y0)
    one = torch.ones_like(dx)
    sx = torch.where(x1 >= x0, one, -one)[:, None]
    sy = torch.where(y1 >= y0, one, -one)[:, None]
    ell = torch.maximum(dx, dy)[:, None]
    i = torch.arange(k, dtype=torch.int32, device=x1.device)[None, :]
    dxe, dye = dx[:, None], dy[:, None]

    def minor_steps(d_minor, d_major):
        a = 2 * i * d_minor - d_major
        b = 2 * torch.clamp(d_major, min=1)
        return torch.clamp(-torch.div(-a, b, rounding_mode="floor"), min=0)

    x_driven = dxe > dye
    kx = minor_steps(dye, dxe)  # y-steps when x-driven
    ky = minor_steps(dxe, dye)  # x-steps when y-driven
    px = torch.where(x_driven, x0 + sx * i, x0 + sx * ky)
    py = torch.where(x_driven, y0 + sy * kx, y0 + sy * i)
    in_ray = (i <= ell) & ray_valid[:, None]
    return RayCells(px=px, py=py, body=in_ray & (i < ell), endpoint=in_ray & (i == ell))


def raster_update_plain(occ, meta, ey, ex, live, accept=None, *, side_y: int, side_x: int, k: int,
                        p_occ_inc: float, p_free_decay: float, block_threshold: float):
    """Plain version of the kernel (same arguments, same result)."""
    w = occ.shape[1]
    y0, x0, rly, rlx = meta[0].long(), meta[1].long(), meta[2], meta[3]
    cells = bresenham_cells(rlx, rly, ex, ey, live, k)
    in_win = (cells.py >= 0) & (cells.py < side_y) & (cells.px >= 0) & (cells.px < side_x)
    body = cells.body & in_win
    end = cells.endpoint & in_win
    ly = torch.clamp(cells.py, 0, side_y - 1).long()
    lx = torch.clamp(cells.px, 0, side_x - 1).long()
    flat = occ.reshape(-1)
    # frozen scan-start probabilities: the first blocked body cell ends the ray
    blocked = body & (flat[(y0 + ly) * w + (x0 + lx)] >= block_threshold)
    i = torch.arange(k, device=occ.device)[None, :]
    first = torch.where(blocked, i, torch.full_like(i, k)).min(dim=1, keepdim=True).values
    free = body & (i < first)
    end = end & (first == k)
    local = (ly * side_x + lx).reshape(-1)
    n_cells = side_y * side_x
    zeros = torch.zeros(n_cells, dtype=torch.float32, device=occ.device)
    n_free = zeros.scatter_add(0, local, free.reshape(-1).to(torch.float32))
    n_end = zeros.scatter_add(0, local, end.reshape(-1).to(torch.float32))
    wy = torch.arange(side_y, device=occ.device)[:, None]
    wx = torch.arange(side_x, device=occ.device)[None, :]
    widx = ((y0 + wy) * w + (x0 + wx)).reshape(-1)
    p = flat[widx] * torch.pow(torch.tensor(p_free_decay, dtype=torch.float32, device=occ.device), n_free)
    p = torch.clamp(p + p_occ_inc * n_end, max=1.0)
    if accept is not None:
        p = torch.where(accept, p, flat[widx])
    return flat.scatter(0, widx, p).reshape(occ.shape)


def raster_update(occ, meta, ey, ex, live, accept=None, *, side_y: int, side_x: int, k: int,
                  p_occ_inc: float, p_free_decay: float, block_threshold: float):
    """One scan's occupancy update.

    Args:
      occ: ``(H, W)`` f32 probability grid (not modified).
      meta: ``(4,)`` int32 ``[y0, x0, rly, rlx]``; the window
        ``[y0, y0 + side_y) x [x0, x0 + side_x)`` must lie inside the grid.
      ey/ex: ``(N,)`` int32 window-local endpoint cells; live: ``(N,)`` bool.
      accept: ``()`` bool, or ``None`` for always: the window is updated
        only where it is true (the SLAM step's accept flag, kept on the
        device so the step needs no select over the grid).
      k: samples per ray (``> window_px``).

    Returns the updated ``(H, W)`` grid.  Launches the CUDA kernel for CUDA
    tensors; the plain version runs only for CPU tensors.
    """
    dev = occ.device
    h, w = occ.shape
    n = ey.shape[0]
    pallas.check_tensor(occ, "occ", torch.float32, (h, w), dev)
    pallas.check_tensor(meta, "meta", torch.int32, (4,), dev)
    pallas.check_tensor(ey, "ey", torch.int32, (n,), dev)
    pallas.check_tensor(ex, "ex", torch.int32, (n,), dev)
    pallas.check_tensor(live, "live", torch.bool, (n,), dev)
    if accept is not None:
        pallas.check_tensor(accept, "accept", torch.bool, (), dev)
    if not (0 < side_y <= h and 0 < side_x <= w):
        raise ValueError(f"window {side_y}x{side_x} does not fit the grid {h}x{w}")
    kw = dict(side_y=side_y, side_x=side_x, k=k, p_occ_inc=p_occ_inc,
              p_free_decay=p_free_decay, block_threshold=block_threshold)
    if dev.type == "cpu":
        return raster_update_plain(occ, meta, ey, ex, live, accept, **kw)
    if dev.type != "cuda":
        raise ValueError(f"raster_update: unsupported device {dev}")
    out = torch.empty_like(occ)  # the kernel writes every cell
    counts = torch.zeros(2 * side_y * side_x, dtype=torch.int32, device=dev)
    err = _lib.lib().slam_raster_update(
        occ.data_ptr(), out.data_ptr(), h, w, meta.data_ptr(), ey.data_ptr(), ex.data_ptr(),
        live.data_ptr(), None if accept is None else accept.data_ptr(), n, side_y, side_x,
        int(k), float(block_threshold),
        float(p_free_decay), float(p_occ_inc), counts.data_ptr(), _lib.stream_ptr(dev),
    )
    _lib.check(err, "raster_update")
    pallas.LAUNCHES["raster_update"] += 1
    return out
