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
