"""K2 and K4: one scan's occupancy update inside the window around the robot.

Counterparts of the JAX package's ``raster_update_pallas`` (K2, the window
variant the default 833 x 1000 grid takes) and ``raster_update_grid_pallas``
(K4, the full-grid variant with its grid aliased to its output, batched over
the fleet's robot axis; both in ``ops/pallas/raster_fused.py``).  The CUDA kernels are in
``csrc/raster.cu``; the source says what bounds them and how they are laid
out.  A call is one device launch: a thread-block cluster a robot, with the
counts in the cluster's shared memory; `raster_plan` picks the layout of
`layouts` from the shapes, and every layout gives the same bits.

All versions take the FULL grids ``(B, H, W)`` plus ``meta (B, 4) = [y0, x0,
rly, rlx]`` per robot (window origin in the grid, robot cell in the window)
and optional ``accept (B,)`` flags as device tensors, so the caller never
reads them on the host.  Cells outside a robot's ``(side_y, side_x)`` window,
and every cell of a robot whose flag is false, keep their values.  K2
(`raster_update`) returns new grids; K4 (`raster_update_grid`) updates the
caller's grids IN PLACE and returns the same tensor, as the TPU kernel does
through its aliased output.  Both take grids of any shape, any window a
row of which fits a block's shared memory (up to 12,088 cells wide) and any
number of samples a ray: a window whose tables fit no block is taken in
bands of rows inside the same launch (`raster_plan` says how many, and
raises where nothing fits, on any device).
"""

from __future__ import annotations

import functools
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


MAX_SMEM = 232448  # shared memory a block may take on the card
TWO_BLOCKS_SMEM = 115712  # shared memory a block may take for two to share a multiprocessor
CLUSTER = 16  # blocks a robot's window takes (`kCluster` in csrc/raster.cu)
H100_CLUSTERS = 7  # clusters of 1024-thread blocks an H100 holds at once (`slam_raster_max_clusters`)
MAX_RAYS = 65535  # both counts of a cell share one uint32, 16 bits each


def band_rows(side_y: int, bands: int) -> int:
    """Window rows a rank owns in each of ``bands`` bands."""
    rows = -(-side_y // CLUSTER)  # of the whole window
    return -(-rows // bands)


def smem_bytes(side_y: int, side_x: int, threads: int, bands: int = 1) -> int:
    """Shared memory a block of ``threads`` of ``csrc/raster.cu`` takes (its
    `layout`) in ``bands`` bands of rows: the count tables Ty (the rank's
    rows of a band, ``side_x + 1`` words apart), Tx (its columns) and Rx (the
    column counts of its rows, received; each rank's part padded to 4 words
    modulo 32), the rank's rows of the band (rows of ``side_x + 6`` floats
    rounded down to 4), where each ray of a group of 512 stops, each ray's
    geometry (32 bytes) twice (as it comes and sorted), the decay^n table of
    512 floats, the rays by kind and samples (800 bytes) and three barriers.
    At 512 threads (compact) no rows are staged, the geometry shares Rx's
    space and the stops the decay^n table's."""
    rows = band_rows(side_y, bands)
    cols = (-(-side_x // CLUSTER) + 3) & ~3
    rx = CLUSTER * (rows * cols + ((4 - rows * cols) & 31)) * 4
    ty_tx = ((rows * (side_x + 1) * 4 + 15) & ~15) + CLUSTER * rows * cols * 4
    if threads < 1024:
        return ty_tx + max(rx, 512 * 32 * 2) + 512 * 4 + 800 + 24
    return ty_tx + rx + rows * ((side_x + 6) & ~3) * 4 + 512 * 4 + 512 * 32 * 2 + 512 * 4 + 800 + 24


class RasterPlan(NamedTuple):
    """A launch layout of K2 or K4 (`raster_plan`)."""

    threads: int        # a block's: 1024, or 512 with half the shared memory (two blocks a multiprocessor)
    smem_bytes: int     # shared memory a block takes (`smem_bytes`)
    copy_clusters: int  # K2: clusters after the B robots' that copy every cell outside the windows; K4: 0
    copy_vec: int       # K2: cells a copied vector (4: 16-byte vectors; 1 where the row width or address forbids)
    copy_chunk: int     # K2: vectors a copying block takes, one contiguous run
    bands: int = 1      # bands of rows the window is taken in, one after another in the launch


@functools.lru_cache(maxsize=64)
def layouts(b: int, h: int, w: int, side_y: int, side_x: int, n: int, k: int, *, in_place: bool = False,
            sm: int = 132, aligned: bool = True, capacity: int = H100_CLUSTERS) -> tuple[RasterPlan, ...]:
    """The launch layouts of K2 (``in_place=False``) or K4 for ``b`` grids of
    ``h x w``, a ``side_y x side_x`` window, ``n`` rays a robot and ``k``
    samples a ray, as ``csrc/raster.cu`` computes them from the same numbers:
    a cluster of `CLUSTER` blocks a robot, rank r taking the window rows and
    columns r modulo `CLUSTER`, the rows in the fewest bands whose tables fit
    a block (one at the presets' 384 x 384), 1024 or 512 threads a block
    (the same bits).  1024 first while the card holds the robots' clusters
    at once (``capacity`` clusters of 1024-thread blocks), where latency
    counts; 512 first beyond, where two blocks share a multiprocessor and
    throughput counts (measured: `PERF.md`).  ``aligned``: both grids'
    addresses are multiples of 16 bytes.  Empty for ``k < 1``; raises
    ``ValueError`` for ``n > MAX_RAYS``."""
    if n > MAX_RAYS:
        raise ValueError(f"raster update: {n} rays a robot, at most {MAX_RAYS} (the counts are 16 bits)")
    if b * h * w >= 2 ** 31 and not in_place:
        raise ValueError(f"raster update: {b} x {h} x {w} cells, the copy indexes fewer than 2^31")
    plans = []
    for t in ((512, 1024) if b > capacity else (1024, 512)):
        bands = fewest_bands(side_y, side_x, t) if k > 0 else 0
        copy = (0, 0, 0)
        if bands and not in_place:
            vec = 4 if w % 4 == 0 and aligned else 1
            vectors = b * h * w // vec
            # the card's multiprocessors beside the robots' clusters, at least a
            # cluster a robot, and no cluster with less than a vector a thread
            clusters = max(1, min(max((sm - b * CLUSTER) // CLUSTER, b), -(-vectors // (CLUSTER * t))))
            copy = (clusters, vec, -(-vectors // (clusters * CLUSTER)))
        plans += [RasterPlan(t, smem_bytes(side_y, side_x, t, bands), *copy, bands)] if bands else []
    return tuple(plans)


@functools.lru_cache(maxsize=64)
def raster_plan(b: int, h: int, w: int, side_y: int, side_x: int, n: int, k: int, *, in_place: bool = False,
                sm: int = 132, aligned: bool = True, capacity: int = H100_CLUSTERS) -> RasterPlan:
    """The first of `layouts` (same arguments); raises ``ValueError`` if none fits."""
    fits = layouts(b, h, w, side_y, side_x, n, k, in_place=in_place, sm=sm, aligned=aligned, capacity=capacity)
    if not fits:
        raise ValueError(f"raster update: a {side_y}x{side_x} window with {k} samples a ray fits no layout ({MAX_SMEM} "
                         f"bytes of shared memory a block, {TWO_BLOCKS_SMEM} at 512 threads; one row a rank at least)")
    return fits[0]


def fewest_bands(side_y: int, side_x: int, threads: int) -> int:
    """The fewest bands of rows whose tables fit a block of ``threads``
    (``TWO_BLOCKS_SMEM`` at 512 so that two share a multiprocessor,
    ``MAX_SMEM`` at 1024), counted without a band that has no rows; 0 where
    not even one row a rank fits."""
    limit = TWO_BLOCKS_SMEM if threads < 1024 else MAX_SMEM
    total = -(-side_y // CLUSTER)
    for bands in range(1, total + 1):
        if smem_bytes(side_y, side_x, threads, bands) <= limit:
            return -(-total // band_rows(side_y, bands))
    return 0


def _launch(entry: str, grids: tuple, occ, meta, ey, ex, live, accept, kw, plan: RasterPlan) -> None:
    """Launch one of the two C entry points on ``grids`` (the data pointers
    that lead its arguments) in the layout ``plan``: one device launch.  A
    window of more than one band gets the ``(B, CLUSTER, N)`` int32 device
    memory where each rank keeps its stops between the bands."""
    b, h, w = occ.shape
    n = ey.shape[1]
    copy = (plan.copy_clusters, plan.copy_vec) if entry == "slam_raster_update" else ()
    stops = torch.empty((b, CLUSTER, max(n, 1)), dtype=torch.int32, device=occ.device) if plan.bands > 1 else None
    err = getattr(_lib.lib(), entry)(
        *grids, b, h, w, meta.data_ptr(), ey.data_ptr(), ex.data_ptr(), live.data_ptr(),
        None if accept is None else accept.data_ptr(), None if stops is None else stops.data_ptr(), n,
        kw["side_y"], kw["side_x"], int(kw["k"]), float(kw["block_threshold"]), float(kw["p_free_decay"]),
        float(kw["p_occ_inc"]), plan.threads, plan.bands, *copy, _lib.stream_ptr(occ.device),
    )
    _lib.check(err, entry)


def _plan(occ, n: int, kw: dict, in_place: bool, out, plan: RasterPlan | None) -> RasterPlan:
    """``plan``, held to `layouts` for these grids on the card they lie on,
    or `raster_plan`'s (for CPU tensors the H100's: a CPU call is refused
    where a card's would be)."""
    b, h, w = occ.shape
    aligned = occ.data_ptr() % 16 == 0 and (out is None or out.data_ptr() % 16 == 0)
    return pallas.chosen("raster update", plan, raster_plan, layouts, b, h, w, kw["side_y"], kw["side_x"], n,
                         int(kw["k"]), in_place=in_place, sm=_lib.sm_count(occ.device), aligned=aligned,
                         capacity=_capacity(occ.device, kw["side_y"], kw["side_x"]))


@functools.lru_cache(maxsize=16)
def _capacity(dev, side_y: int, side_x: int) -> int:
    """Clusters of 1024-thread blocks the card holds at once at this window
    (the H100's for a CPU tensor; 0 where none fits)."""
    if dev.type != "cuda":
        return H100_CLUSTERS
    bands = fewest_bands(side_y, side_x, 1024)
    return max(0, _lib.lib().slam_raster_max_clusters(side_y, side_x, 1024, bands)) if bands else 0


def raster_update(occ, meta, ey, ex, live, accept=None, *, side_y: int, side_x: int, k: int,
                  p_occ_inc: float, p_free_decay: float, block_threshold: float,
                  plan: RasterPlan | None = None):
    """K2: one scan's occupancy update per robot, into new grids.

    Args:
      occ: ``(B, H, W)`` f32 probability grids (not modified).
      meta: ``(B, 4)`` int32 ``[y0, x0, rly, rlx]``; each window
        ``[y0, y0 + side_y) x [x0, x0 + side_x)`` must lie inside the grid.
      ey/ex: ``(B, N)`` int32 window-local endpoint cells; live: ``(B, N)`` bool.
      accept: ``(B,)`` bool, or ``None`` for always: a robot's window is
        updated only where its flag is true (the SLAM step's accept flag,
        kept on the device so the step needs no select over the grid).
      k: samples per ray (``> window_px``; any number).
      plan: one of `layouts` (``None``: `raster_plan`'s).

    Returns the updated grids.  Launches the CUDA kernel for CUDA tensors
    (one launch); the plain version runs only for CPU tensors.
    """
    kw = dict(side_y=side_y, side_x=side_x, k=k, p_occ_inc=p_occ_inc,
              p_free_decay=p_free_decay, block_threshold=block_threshold)
    _check(occ, meta, ey, ex, live, accept, side_y, side_x)
    if occ.device.type == "cpu":
        _plan(occ, ey.shape[1], kw, False, None, plan)
        return raster_update_plain(occ, meta, ey, ex, live, accept, **kw)
    out = torch.empty_like(occ)  # the kernel writes every cell
    plan = _plan(occ, ey.shape[1], kw, False, out, plan)
    _launch("slam_raster_update", (occ.data_ptr(), out.data_ptr()), occ, meta, ey, ex, live, accept, kw, plan)
    pallas.LAUNCHES["raster_update"] += 1
    return out


def raster_update_grid(occ, meta, ey, ex, live, accept=None, *, side_y: int, side_x: int, k: int,
                       p_occ_inc: float, p_free_decay: float, block_threshold: float,
                       plan: RasterPlan | None = None):
    """K4: one scan's occupancy update per robot, IN PLACE.

    Arguments as `raster_update`.  The
    caller owns ``occ``: the windows are written into it and the same tensor
    is returned, so no cell outside a window moves through memory.  Launches
    the CUDA kernel for CUDA tensors (one launch); the plain version runs
    only for CPU tensors.
    """
    _check(occ, meta, ey, ex, live, accept, side_y, side_x)
    kw = dict(side_y=side_y, side_x=side_x, k=k, p_occ_inc=p_occ_inc,
              p_free_decay=p_free_decay, block_threshold=block_threshold)
    plan = _plan(occ, ey.shape[1], kw, True, None, plan)
    if occ.device.type == "cpu":
        return raster_update_grid_plain(occ, meta, ey, ex, live, accept, **kw)
    _launch("slam_raster_update_grid", (occ.data_ptr(),), occ, meta, ey, ex, live, accept, kw, plan)
    pallas.LAUNCHES["raster_update_grid"] += 1
    return occ
