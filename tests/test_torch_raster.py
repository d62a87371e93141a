"""K2 (the occupancy raster) and the raster ops: the port's plain version vs
the JAX ``update_occupancy`` on its fused Pallas path in interpret mode, on
a 400 x 400 grid, and the JAX keep/prune masks."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_slam_yolo_tpu.config import MapConfig as JMap, OccupancyConfig as JOcc
from icp_slam_yolo_tpu.ops import raster as jraster
from icp_slam_yolo_tpu_torch.config import MapConfig as TMap, OccupancyConfig as TOcc
from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops import raster as traster
from icp_slam_yolo_tpu_torch.ops.pallas.raster_fused import raster_update, raster_update_plain

torch.set_num_threads(2)

JMAP, TMAP = JMap(width_mm=12000.0, height_mm=12000.0), TMap(width_mm=12000.0, height_mm=12000.0)
JOCC, TOCC = JOcc(backend="fused"), TOcc()


def _t(a):
    return torch.from_numpy(np.array(a))


def _update(occ, pts, valid, robot, accept=None):
    """The port's `update_occupancy` on one robot (a leading axis of 1)."""
    return traster.update_occupancy(occ[None], pts[None], valid[None], robot[None], TMAP, TOCC,
                                    None if accept is None else accept[None])[0]


def _grid_with_wall(rng):
    occ = np.full((400, 400), 0.5, np.float32)
    occ += rng.uniform(-0.3, 0.3, occ.shape).astype(np.float32) * (rng.random(occ.shape) < 0.1)
    occ[150:260, 245:248] = 0.9  # an occupied wall right of the map centre
    return occ


def _rays(rng, n, robot, spread=4500.0):
    pts = (robot + rng.uniform(-spread, spread, (n, 2))).astype(np.float32)
    return pts, rng.random(n) < 0.9


@pytest.mark.parametrize("robot,n", [
    ((150.0, -90.0), 512),      # interior, in front of the wall
    ((-5500.0, 5600.0), 301),   # map corner: window clamps, odd ray count
    ((5900.0, -100.0), 200),    # right border: rays leave the grid
    ((-7000.0, 0.0), 64),       # robot off the grid
])
def test_update_matches_fused_interpret(rng, robot, n):
    """atol 1e-5: counts are exact integers on both sides; decay^n comes
    from two pow implementations."""
    robot = np.asarray(robot, np.float32)
    occ = _grid_with_wall(rng)
    pts, valid = _rays(rng, n, robot)
    j = jraster.update_occupancy(jnp.asarray(occ), jnp.asarray(pts), jnp.asarray(valid),
                                 jnp.asarray(robot), JMAP, JOCC)
    t = _update(_t(occ), _t(pts), _t(valid), _t(robot))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)
    assert (t.numpy() <= 1.0).all() and (t.numpy() >= 0.0).all()


def test_wall_blocks_rays_and_sequence_agrees(rng):
    """Three scans in a row from one robot cell: the wall shadows the cells
    behind it, and the grids stay equal scan after scan."""
    robot = np.asarray([150.0, -90.0], np.float32)
    occ = _grid_with_wall(rng)
    j, t = jnp.asarray(occ), _t(occ)
    for _ in range(3):
        pts, valid = _rays(rng, 512, robot)
        j = jraster.update_occupancy(j, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(robot), JMAP, JOCC)
        t = _update(t, _t(pts), _t(valid), _t(robot))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)
    behind = t.numpy()[200:210, 255:300]
    assert (behind == occ[200:210, 255:300]).all(), "cells behind the wall must be untouched"
    assert (t.numpy()[200:210, 205:240] < 0.5).any(), "free space in front of the wall must decay"


def test_accept_flag_commits_the_window_only_on_accept(rng):
    """The step's accept flag, read on the device: true gives the update,
    false the input grid unchanged."""
    robot = np.asarray([150.0, -90.0], np.float32)
    occ = _grid_with_wall(rng)
    pts, valid = _rays(rng, 300, robot)
    args = (_t(occ), _t(pts), _t(valid), _t(robot))
    always = _update(*args)
    assert torch.equal(_update(*args, torch.tensor(True)), always)
    assert not torch.equal(always, _t(occ))
    assert torch.equal(_update(*args, torch.tensor(False)), _t(occ))


def test_world_to_px_truncates_toward_zero():
    xy = np.array([[-15014.9, 12510.0], [-29.9, 29.9], [0.0, -0.1], [15000.0, -12500.0]], np.float32)
    map_cfg = JMap()
    jx, jy = jraster.world_to_px(jnp.asarray(xy), map_cfg)
    tx, ty = traster.world_to_px(_t(xy), TMap())
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tx.dtype == torch.int32


def test_bresenham_cells_exact(rng):
    x1 = rng.integers(-150, 150, 200).astype(np.int32)
    y1 = rng.integers(-150, 150, 200).astype(np.int32)
    x1[:4], y1[:4] = [7, 7, -7, 0], [7, -3, 7, 0]  # diagonal tie, shallow, steep, zero length
    live = rng.random(200) < 0.9
    j = jraster.bresenham_cells(jnp.int32(3), jnp.int32(-2), jnp.asarray(x1), jnp.asarray(y1),
                                jnp.asarray(live), 160)
    t = traster.bresenham_cells(torch.tensor(3, dtype=torch.int32), torch.tensor(-2, dtype=torch.int32),
                                _t(x1), _t(y1), _t(live), 160)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("margin", [-1, 0, 32])
def test_keep_and_prune_masks(rng, margin):
    occ = rng.uniform(0.0, 1.0, (400, 400)).astype(np.float32)
    pts = rng.uniform(-7000, 7000, (700, 2)).astype(np.float32)  # some off the grid
    valid = rng.random(700) < 0.9
    robot = np.asarray([-5000.0, 4000.0], np.float32)
    jo = JOcc(prune_window_margin_px=margin)
    to = TOcc(prune_window_margin_px=margin)
    jk = jraster.occupancy_keep_mask(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(occ), JMAP, 0.2)
    tk = traster.occupancy_keep_mask(_t(pts), _t(valid), _t(occ), TMAP, 0.2)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jp = jraster.prune_keep_mask(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(occ),
                                 jnp.asarray(robot), JMAP, jo)
    tp = traster.prune_keep_mask(_t(pts), _t(valid), _t(occ), _t(robot), TMAP, to)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_wrapper_checks_and_cpu_path():
    occ = torch.full((1, 400, 400), 0.5)
    meta = torch.tensor([[10, 10, 140, 140]], dtype=torch.int32)
    ey = torch.tensor([[150, 20]], dtype=torch.int32)
    ex = torch.tensor([[30, 300]], dtype=torch.int32)
    live = torch.tensor([[True, True]])
    kw = dict(side_y=384, side_x=384, k=144, p_occ_inc=0.2, p_free_decay=0.9, block_threshold=0.65)
    before = pallas.LAUNCHES["raster_update"]
    out = raster_update(occ, meta, ey, ex, live, **kw)
    assert torch.equal(out, raster_update_plain(occ, meta, ey, ex, live, **kw))
    assert pallas.LAUNCHES["raster_update"] == before
    assert torch.equal(occ, torch.full((1, 400, 400), 0.5)), "the input grid is not modified"
    with pytest.raises(ValueError):
        raster_update(occ, meta, ey, ex, live, **dict(kw, side_y=512))
    with pytest.raises(TypeError):
        raster_update(occ, meta.long(), ey, ex, live, **kw)
    with pytest.raises(TypeError):
        raster_update(occ, meta, ey, ex, live, torch.tensor([1]), **kw)
    with pytest.raises(ValueError, match="occ"):  # one robot still carries the leading axis
        raster_update(occ[0], meta, ey, ex, live, **kw)
    with pytest.raises(NotImplementedError):
        traster.update_occupancy(occ, torch.zeros((1, 2, 2)), live, torch.zeros((1, 2)), TMAP,
                                 dataclasses.replace(TOCC, backend="xla"))


# ---- the launch layout of K2 and K4 (`raster_plan`), at every preset's shape

def _preset_shapes():
    """(name, grid h, w, window side_y, side_x, samples a ray) of every preset."""
    from icp_slam_yolo_tpu_torch import config as tc

    out = []
    for name in sorted(tc.PRESETS):
        cfg = tc.PRESETS[name]
        h, w = cfg.map.height_px, cfg.map.width_px
        out.append((name, h, w, *traster.window_dims(h, w, cfg.occupancy), cfg.occupancy.max_ray_px))
    return out


@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("in_place", [False, True])
def test_raster_plan_fits_every_preset(b, in_place):
    """At every preset's grid and window, for K2 and K4: the picked layout's
    shared memory stays within a block's 227 KB (half of a multiprocessor's
    228 KB at 512 threads, so that two blocks share it), the ranks' rows
    (rank r of the cluster of C = 16: window rows r, r + C, ...) cover the
    window once, the whole window is one band (the layout and time of the
    presets' window do not change with the bands), and the blocks have 1024
    threads while the robots' clusters fit the card at once, 512 beyond."""
    from icp_slam_yolo_tpu_torch.ops.pallas import raster_fused as rf

    for name, h, w, side_y, side_x, k in _preset_shapes():
        plan = rf.raster_plan(b, h, w, side_y, side_x, 512, k, in_place=in_place)
        limit = rf.TWO_BLOCKS_SMEM if plan.threads == 512 else rf.MAX_SMEM
        assert plan.smem_bytes == rf.smem_bytes(side_y, side_x, plan.threads) <= limit <= 232448, name
        assert plan.bands == 1, name
        assert plan.threads == (512 if b > rf.H100_CLUSTERS else 1024), name
        rows = np.concatenate([np.arange(r, side_y, rf.CLUSTER) for r in range(rf.CLUSTER)])
        np.testing.assert_array_equal(np.sort(rows), np.arange(side_y), err_msg=name)
        assert (plan.copy_clusters > 0) == (not in_place), name


def _copied_cells(plan, b, h, w, side_y, side_x, meta):
    """How often K2's copying blocks write each cell, as ``copy_outside`` in
    csrc/raster.cu does: block k takes vectors [k chunk, (k + 1) chunk) of
    ``copy_vec`` cells and writes the cells of each that lie outside the
    window of the vector's robot."""
    from icp_slam_yolo_tpu_torch.ops.pallas import raster_fused as rf

    vec, total = plan.copy_vec, b * h * w // plan.copy_vec
    written = np.zeros(b * h * w, np.int32)
    for blk in range(plan.copy_clusters * rf.CLUSTER):
        q0, q1 = blk * plan.copy_chunk, min((blk + 1) * plan.copy_chunk, total)
        if q0 >= q1:
            continue
        cells = np.arange(q0 * vec, q1 * vec)
        rb, rest = cells // (h * w), cells % (h * w)
        y, x = rest // w, rest % w
        wy, wx = y - meta[rb, 0], x - meta[rb, 1]
        inside = (wy >= 0) & (wy < side_y) & (wx >= 0) & (wx < side_x)
        np.add.at(written, cells[~inside], 1)
    return written


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("aligned", [True, False])
def test_raster_copy_covers_the_outside_once(rng, b, aligned):
    """K2's copying clusters, at every preset's grid and window: each cell
    outside a robot's window is written exactly once, no window cell is
    (the robots' clusters write those)."""
    from icp_slam_yolo_tpu_torch.ops.pallas import raster_fused as rf

    for name, h, w, side_y, side_x, k in _preset_shapes():
        plan = rf.raster_plan(b, h, w, side_y, side_x, 512, k, aligned=aligned)
        assert plan.copy_vec == (4 if aligned and w % 4 == 0 else 1)
        meta = np.stack([rng.integers(0, h - side_y + 1, b), rng.integers(0, w - side_x + 1, b)], axis=1)
        written = _copied_cells(plan, b, h, w, side_y, side_x, meta).reshape(b, h, w)
        for r in range(b):
            inside = np.zeros((h, w), bool)
            inside[meta[r, 0]: meta[r, 0] + side_y, meta[r, 1]: meta[r, 1] + side_x] = True
            assert (written[r][inside] == 0).all(), name
            assert (written[r][~inside] == 1).all(), name


def test_raster_copy_chunks_tile_the_grids_at_64_robots():
    """At B = 64 the copying blocks' runs of vectors tile the grids with no
    gap and no overlap (the per-cell check above runs at B = 1 and 8)."""
    from icp_slam_yolo_tpu_torch.ops.pallas import raster_fused as rf

    for name, h, w, side_y, side_x, k in _preset_shapes():
        plan = rf.raster_plan(64, h, w, side_y, side_x, 512, k)
        total = 64 * h * w // plan.copy_vec
        blocks = plan.copy_clusters * rf.CLUSTER
        assert w % plan.copy_vec == 0 and (blocks - 1) * plan.copy_chunk < total <= blocks * plan.copy_chunk, name


def test_raster_plan_refuses_what_fits_no_layout():
    """A window not one row of which a rank fits in a block's shared memory
    (a band of one row a rank), a plan of threads whose layout does not
    fit, or no sample a ray: a ValueError, never another kernel or the plain
    version."""
    from icp_slam_yolo_tpu_torch.ops.pallas import raster_fused as rf

    with pytest.raises(ValueError, match="fits no layout"):  # one row a rank of Ty, Tx, Rx and the staged row
        rf.raster_plan(1, 64, 20000, 64, 20000, 512, 144, in_place=True)
    # fits 1024 threads (one band), not 512: a plan of 512 threads is refused
    assert [p.threads for p in rf.layouts(64, 32, 11000, 32, 11000, 512, 144, in_place=True)] == [1024]
    assert rf.raster_plan(64, 32, 11000, 32, 11000, 512, 144, in_place=True).threads == 1024
    occ = torch.full((1, 32, 11000), 0.5)
    rays = (torch.zeros((1, 4), dtype=torch.int32),) * 2 + (torch.ones((1, 4), dtype=torch.bool),)
    with pytest.raises(ValueError, match="no layout"):
        rf.raster_update_grid(occ, torch.zeros((1, 4), dtype=torch.int32), *rays, side_y=32, side_x=11000, k=144,
                              p_occ_inc=0.2, p_free_decay=0.9, block_threshold=0.65,
                              plan=rf.RasterPlan(512, rf.smem_bytes(32, 11000, 512), 0, 0, 0, 1))
    with pytest.raises(ValueError, match="fits no layout"):
        rf.raster_plan(1, 833, 1000, 384, 384, 512, 0)
    assert [p.threads for p in rf.layouts(1, 100, 120, 64, 64, 200, 30)] == [1024, 512]


@pytest.mark.parametrize("case", ["1024x1024", "k=513", "416 at 512 threads", "640, k=1100"])
def test_raster_plan_takes_big_windows_in_bands(case):
    """What the kernels refused before they took bands: a window whose
    tables fit no block is cut into the fewest bands of rows that fit (each
    a multiple of the cluster's 16 rows, the last one shorter), the shared
    memory the plan states; a ray of more than 512 samples needs no band."""
    from icp_slam_yolo_tpu_torch.ops.pallas import raster_fused as rf

    args, bands, threads = {  # (b, h, w, side_y, side_x, n, k), bands, threads a block
        "1024x1024": ((1, 2048, 2048, 1024, 1024, 512, 144), 6, 1024),
        "k=513": ((1, 833, 1000, 384, 384, 512, 513), 1, 1024),
        "416 at 512 threads": ((64, 864, 1024, 416, 416, 512, 144), 2, 512),
        "640, k=1100": ((8, 864, 1024, 640, 640, 1100, 1100), 3, 512),  # 8 robots: 512 threads
    }[case]
    plan = rf.raster_plan(*args)
    side_y, side_x = args[3], args[4]
    assert plan.bands == bands
    assert plan.threads == threads
    limit = rf.TWO_BLOCKS_SMEM if plan.threads == 512 else rf.MAX_SMEM
    assert plan.smem_bytes == rf.smem_bytes(side_y, side_x, plan.threads, bands) <= limit
    assert bands == 1 or rf.smem_bytes(side_y, side_x, plan.threads, bands - 1) > limit  # the fewest
    rows = rf.band_rows(side_y, bands)
    cover = [range(rf.CLUSTER * rows * j, min(rf.CLUSTER * rows * (j + 1), side_y)) for j in range(bands)]
    assert [y for band in cover for y in band] == list(range(side_y)) and all(len(band) for band in cover)


@pytest.mark.parametrize("window_px", [193, 256])
def test_window_beyond_384_px_matches_jax(rng, window_px):
    """A window of more than 384 cells a side (``window_px`` above 192:
    `window_dims` makes it 512), which the kernels take in two bands, and
    at 256 rays of more than 512 samples: the port's ``update_occupancy``
    against the JAX package's fused Pallas raster in interpret mode, a few
    rays crossing the whole window (atol 1e-5, as above)."""
    max_ray = {193: 392, 256: 520}[window_px]  # the JAX kernel takes multiples of 8
    jocc = dataclasses.replace(JOCC, window_px=window_px, max_ray_px=max_ray)
    tocc = dataclasses.replace(TOCC, window_px=window_px, max_ray_px=max_ray)
    jmap = dataclasses.replace(JMAP, width_mm=18000.0, height_mm=18000.0)  # 600 x 600 cells
    tmap = dataclasses.replace(TMAP, width_mm=18000.0, height_mm=18000.0)
    assert traster.window_dims(600, 600, tocc) == (512, 512)
    from icp_slam_yolo_tpu_torch.ops.pallas import raster_fused as rf

    assert rf.raster_plan(1, 600, 600, 512, 512, 256, max_ray).bands == 2
    occ = np.full((600, 600), 0.5, np.float32)
    occ += rng.uniform(-0.3, 0.3, occ.shape).astype(np.float32) * (rng.random(occ.shape) < 0.1)
    occ[100:500, 420:423] = 0.9  # a wall some rays stop at
    robot = np.asarray([200.0, 300.0], np.float32)
    pts = (robot + rng.uniform(-window_px * 30.0, window_px * 30.0, (256, 2))).astype(np.float32)
    pts[:4] = robot + np.float32(window_px * 30.0 - 45.0) * np.array([[1, 0], [-1, 0], [0, 1], [-1, -1]], np.float32)
    valid = rng.random(256) < 0.9
    valid[:4] = True
    j = jraster.update_occupancy(jnp.asarray(occ), jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(robot),
                                 jmap, jocc)
    t = traster.update_occupancy(_t(occ)[None], _t(pts)[None], _t(valid)[None], _t(robot)[None], tmap, tocc)[0]
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)
    assert not np.array_equal(t.numpy(), occ)


def test_wrapper_refuses_65536_rays():
    """Both counts of a cell share one uint32, 16 bits each: a robot with
    65536 rays is refused, on the CPU as on the card."""
    occ = torch.full((1, 400, 400), 0.5)
    meta = torch.tensor([[10, 10, 140, 140]], dtype=torch.int32)
    n = 65536
    ey = torch.full((1, n), 150, dtype=torch.int32)
    ex = torch.full((1, n), 30, dtype=torch.int32)
    live = torch.ones((1, n), dtype=torch.bool)
    kw = dict(side_y=384, side_x=384, k=144, p_occ_inc=0.2, p_free_decay=0.9, block_threshold=0.65)
    for fn in (raster_update, traster.raster_update_grid):
        with pytest.raises(ValueError, match="65535"):
            fn(occ.clone(), meta, ey, ex, live, **kw)
