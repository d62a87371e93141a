"""The robot axis: batched K1, K3 and K4 (their plain versions, on the CPU)
against the JAX package's batched Pallas kernels in interpret mode, and the
fleet replay against JAX ``fleet_run_sequence`` and against the port's own
single-robot lanes, on seeded synthetic warehouse scans.

Tolerances: K1 as in test_torch_icp.py (1 mm / 2e-3 rad / 1 mm); K3 and K4
exact; the port's fleet against its own single-robot lanes exactly.  The
fleet replay against JAX: equal accept flags and poses within 2 mm / 2e-3
rad, as every other replay of the port, on a cut whose registrations run to
their fixed point (see `test_fleet_replay_matches_jax`); at the preset's own
stopping rule only the coarser bound of
`test_fleet_replay_at_the_preset_tolerance` can hold, for the reason given
there."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import icp_slam_yolo_tpu_torch as port
from icp_slam_yolo_tpu import config as jc
from icp_slam_yolo_tpu.ops import raster as jraster
from icp_slam_yolo_tpu.ops.pallas.icp_fused import _fused_batched
from icp_slam_yolo_tpu.parallel import fleet as jfleet
from icp_slam_yolo_tpu_torch import config as tc
from icp_slam_yolo_tpu_torch.convert import state_from_numpy, state_to_numpy
from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops import raster as traster
from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import icp_fused
from icp_slam_yolo_tpu_torch.ops.pallas.nn_kernel import nn_argmin
from icp_slam_yolo_tpu_torch.ops.pallas.raster_fused import raster_update, raster_update_grid
from icp_slam_yolo_tpu_torch.parallel import fleet as tfleet
from icp_slam_yolo_tpu_torch.slam import pipeline as tpipe
from test_torch_icp import _room_pair

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cut_fleet(m, capacity=1024, side_mm=11520.0, **icp):
    """The ``fleet`` preset cut as the JAX package's own fleet test cuts it:
    a 384 x 384 tile-shaped grid, a 100 px window, 1024 map slots and 10 ICP
    iterations (``capacity``, ``side_mm`` and ``icp`` fields override)."""
    return m.FLEET_CONFIG.replace(
        map=m.MapConfig(width_mm=side_mm, height_mm=side_mm),
        occupancy=dataclasses.replace(m.FLEET_CONFIG.occupancy, window_px=100, max_ray_px=112),
        map_capacity=capacity, local_map_capacity=capacity,
        icp=dataclasses.replace(m.FLEET_CONFIG.icp, **{"max_iterations": 10, **icp}),
    )


def _streams(n_scans, seeds=(7, 11)):
    """Distinct seeded streams in a 10 m x 8 m hall: ``(B, n_scans, 512, 3)``."""
    out = np.zeros((len(seeds), n_scans, 512, 3), np.float32)
    for b, seed in enumerate(seeds):
        scans, _ = chip_smoke.synthetic_sequence(n_scans, seed=seed, half_x=5000.0, half_y=4000.0,
                                                 path_half_x=2500.0, path_half_y=1500.0, radius=1000.0)
        out[b, :, : scans.shape[1]] = scans
    return out


# ------------------------------------------------------------------ kernels

@pytest.mark.parametrize("anderson", [False, True])
def test_batched_k1_matches_pallas_interpret(anderson):
    """B = 3 registrations of different difficulty in one call (they converge
    at different iterations) against JAX ``_fused_batched``."""
    pairs = [[np.array(x) for x in _room_pair(seed=s, t_slots=384)] for s in (5, 9, 11)]
    inits = np.array([[30.0, -20.0, 0.01], [60.0, 40.0, -0.02], [0.0, 0.0, 0.0]], np.float32)
    pairs[2][1][np.flatnonzero(pairs[2][1])[40:]] = False  # a sparse source
    arrays = [np.stack([p[i] for p in pairs]) for i in range(4)] + [inits]
    kw = dict(iters=30, threshold_mm=200.0, tolerance=1e-2, anderson=anderson)
    jp, jr, jn, ji = (np.asarray(x) for x in _fused_batched(
        *(jnp.asarray(a) for a in arrays), early_exit=True, interpret=True, tile_t=None, **kw))
    tp, tr, tn, ti = (x.numpy() for x in icp_fused(*(_t(a) for a in arrays), **kw))
    assert tp.shape == (3, 3) and ti.dtype == np.int32
    assert np.abs(tp[:, :2] - jp[:, :2]).max() <= 1.0 and np.abs(tp[:, 2] - jp[:, 2]).max() <= 2e-3
    assert np.abs(tr - jr).max() <= 1.0 and np.abs(tn - jn).max() <= 2
    assert np.abs(ti - ji).max() <= 3 and len(set(ti.tolist())) > 1, (ti, ji)
    for b in range(3):  # one launch of three against three single calls
        one = icp_fused(*(_t(a[b: b + 1]) for a in arrays), **kw)
        assert torch.equal(one[0][0], _t(tp[b])) and int(one[3]) == ti[b]


def test_batched_k3_ties_per_robot(rng):
    base = rng.uniform(-3000, 3000, (3, 64, 2)).astype(np.float32)
    tgt = _t(np.concatenate([base, base], axis=1))  # every target twice: ties
    valid = _t(rng.random((3, 128)) < 0.8)
    valid[1] = False
    src = _t(rng.uniform(-3000, 3000, (3, 50, 2)).astype(np.float32))
    before = pallas.LAUNCHES["nn_argmin"]
    d2, idx = nn_argmin(src, tgt, valid)
    assert pallas.LAUNCHES["nn_argmin"] == before
    assert d2.shape == (3, 50) and idx.dtype == torch.int32
    for b in range(3):
        d1, i1 = nn_argmin(src[b: b + 1], tgt[b: b + 1], valid[b: b + 1])
        assert torch.equal(d1[0], d2[b]) and torch.equal(i1[0], idx[b])
    assert (idx[0] < 64).all() or not valid[0, :64].all()  # first index of a tie
    assert (d2[1] == 1e30).all() and (idx[1] == 0).all()
    with pytest.raises(ValueError, match="tgt_valid"):
        nn_argmin(src, tgt, valid[:2])


def _grid_case(rng, b=3, h=384, w=384):
    occ = rng.uniform(0.0, 1.0, (b, h, w)).astype(np.float32)
    occ[:, ::3] = 0.5  # free rows, so rays run
    robots = np.array([[150.0, -90.0], [-5500.0, 5600.0], [4000.0, 2000.0]], np.float32)[:b]  # one near a corner
    pts = robots[:, None] + rng.uniform(-3300, 3300, (b, 512, 2)).astype(np.float32)
    valid = rng.random((b, 512)) < 0.9
    return occ, pts, valid, robots


def test_k4_matches_pallas_grid_kernel_interpret(rng):
    """``update_occupancy`` on grids the caller gives up (``in_place``): the
    port's K4 (plain version) against JAX ``raster_update_grid_pallas``
    (reached through ``vmap`` of its ``update_occupancy`` on a tile-shaped
    grid), B = 3 robots at different window origins.  The two use different
    windows (the JAX one is aligned to its DMA tiles); the grids must agree
    all the same.  Without ``in_place`` (K2) the caller's grid keeps its
    values and the new grid is the same."""
    jcfg, tcfg = _cut_fleet(jc), _cut_fleet(tc)
    occ, pts, valid, robots = _grid_case(rng)
    assert jraster._fused_grid_dims(384, 384, jcfg.occupancy) is not None
    j = jax.vmap(lambda o, p, v, r: jraster.update_occupancy(o, p, v, r, jcfg.map, jcfg.occupancy))(
        *(jnp.asarray(x) for x in (occ, pts, valid, robots)))
    grid = _t(occ)
    before = pallas.LAUNCHES["raster_update_grid"]
    new = traster.update_occupancy(grid, _t(pts), _t(valid), _t(robots), tcfg.map, tcfg.occupancy)
    assert new is not grid and torch.equal(grid, _t(occ)), "K2 leaves the caller's grid as it was"
    t = traster.update_occupancy(grid, _t(pts), _t(valid), _t(robots), tcfg.map, tcfg.occupancy, in_place=True)
    assert pallas.LAUNCHES["raster_update_grid"] == before, "a CPU call launches no kernel"
    assert t is grid and torch.equal(t, new), "K4 updates the caller's grid in place, to K2's values"
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    changed = t.numpy() != occ
    assert changed.sum() > 500
    rx, ry = (x.numpy() for x in traster.world_to_px(_t(robots), tcfg.map))
    yy, xx = np.mgrid[:384, :384]
    for b in range(3):  # nothing moves outside [r - win, r + win)
        outside = (np.abs(yy - ry[b]) > 100) | (np.abs(xx - rx[b]) > 100)
        assert not changed[b][outside].any()


def test_k4_flags_and_k2_batched(rng):
    """Per-robot accept flags, a robot without a live ray, K2 on the same
    inputs (new grids, equal values), and one robot at a time."""
    tcfg = _cut_fleet(tc)
    occ, pts, valid, robots = _grid_case(rng)
    valid[1] = False
    accept = _t(np.array([True, True, False]))
    h = w = 384
    side_y, side_x = traster.window_dims(h, w, tcfg.occupancy)
    win = tcfg.occupancy.window_px
    rx, ry = traster.world_to_px(_t(robots), tcfg.map)
    ex, ey = traster.world_to_px(_t(pts), tcfg.map)
    y0, x0 = torch.clamp(ry - win, 0, h - side_y), torch.clamp(rx - win, 0, w - side_x)
    inwin = ((ex - rx[:, None]).abs() < win) & ((ey - ry[:, None]).abs() < win) & (ex >= 0) & (ey >= 0)
    meta = torch.stack([y0, x0, ry - y0, rx - x0], dim=1).to(torch.int32)
    args = (meta, (ey - y0[:, None]).contiguous(), (ex - x0[:, None]).contiguous(), _t(valid) & inwin)
    kw = dict(side_y=side_y, side_x=side_x, k=tcfg.occupancy.max_ray_px, p_occ_inc=0.2, p_free_decay=0.9,
              block_threshold=0.65)
    new = raster_update(_t(occ), *args, accept, **kw)
    grid = _t(occ)
    same = raster_update_grid(grid, *args, accept, **kw)
    assert same is grid and torch.equal(new, grid)
    assert not torch.equal(grid[0], _t(occ[0]))
    assert torch.equal(grid[1], _t(occ[1])) and torch.equal(grid[2], _t(occ[2]))
    for b in range(3):
        one = raster_update(_t(occ[b: b + 1]), *(a[b: b + 1] for a in args), accept[b: b + 1], **kw)
        assert torch.equal(one[0], new[b])
    with pytest.raises(ValueError, match="accept"):
        raster_update_grid(grid, *args, accept[:2], **kw)


# ------------------------------------------------------------------ the fleet

def _replay_both(**cut):
    """Two distinct streams x 14 scans through both fleets (the maintenance
    runs once, at tick 9); what must agree whatever the stopping rule."""
    stack = _streams(14)
    jstates, jouts = jfleet.fleet_run_sequence(jnp.asarray(stack), _cut_fleet(jc, **cut))
    tstates, touts = tfleet.fleet_run_sequence(stack, _cut_fleet(tc, **cut), device="cpu")
    assert touts.pose.shape == (2, 13, 3) and touts.accepted.shape == (2, 13)
    np.testing.assert_array_equal(touts.accepted.numpy(), np.asarray(jouts.accepted))
    assert touts.accepted.numpy().mean() > 0.9
    np.testing.assert_array_equal(touts.n_points.numpy(), np.asarray(jouts.n_points))
    for name in ("step", "maint_count", "reject_run"):
        np.testing.assert_array_equal(getattr(tstates, name).numpy(), np.asarray(getattr(jstates, name)))
    dp = np.abs(touts.pose.numpy() - np.asarray(jouts.pose))
    jm, tm = np.asarray(jstates.map_valid).sum(1), tstates.map_valid.sum(1).numpy()
    same_cells = (np.abs(tstates.occ.numpy() - np.asarray(jstates.occ)) <= 1e-5).mean()
    return dp, np.abs(jm - tm).max(), same_cells, (touts.n_iters.tolist(), np.asarray(jouts.n_iters).tolist())


def test_fleet_replay_matches_jax():
    """The cut fleet configuration with registrations that run to their
    fixed point (40 iterations, tolerance 1e-4) and a map buffer that does
    not fill (2048 slots): poses within 2 mm / 2e-3 rad at every scan of both
    robots, map counts within 5 points, 99.5 % of the grid cells equal (a
    pose a fraction of a mm apart moves a few ray endpoints across cell
    borders)."""
    dp, dmap, same_cells, iters = _replay_both(capacity=2048, max_iterations=40, tolerance=1e-4)
    assert dp[..., :2].max() <= 2.0 and dp[..., 2].max() <= 2e-3, (dp.max(axis=(0, 1)), iters)
    assert dmap <= 5 and same_cells >= 0.995, (dmap, same_cells)


def test_fleet_replay_at_the_preset_tolerance():
    """The cut exactly as the JAX package's fleet test has it (10 iterations,
    the preset's tolerance 1e-2, 1024 slots).  There a registration stops
    once its mean error moves by less than 1e-2 mm, while its pose still
    moves by millimetres per iteration; JAX's Gram-form distances and the
    port's difference form differ in the last digits of that mean error, so
    the two stop up to a few iterations apart (both well before the 10th;
    the counts are printed on failure).  The 1024-slot buffer also fills, and
    then a point more or less decides which points `compact` cuts off.  What
    holds: flags, counts and counters equal (`_replay_both`), poses within
    8 mm / 8e-3 rad, and no accumulation: 3 mm at the last scan."""
    dp, dmap, same_cells, iters = _replay_both()
    assert dp[..., :2].max() <= 8.0 and dp[..., 2].max() <= 8e-3, (dp.max(axis=(0, 1)), iters)
    assert dp[:, -1, :2].max() <= 3.0, "the difference must not accumulate"
    assert dmap <= 25 and same_cells >= 0.98, (dmap, same_cells)


def test_fleet_equals_its_single_robot_lanes():
    """Each lane of the batched step against ``make_step`` on that robot
    alone with the same ticks: bit for bit (on the CPU one robot is the
    B = 1 view of the same plain versions)."""
    cfg = _cut_fleet(tc)
    stack = _streams(12)
    tstates, touts = tfleet.fleet_run_sequence(stack, cfg, device="cpu")
    step = tpipe.make_step(cfg)
    for b in range(2):
        scans = torch.from_numpy(stack[b])
        state = tpipe.init_state(scans[0], cfg)
        for t in range(1, 12):
            state, out = step(state, scans[t], t - 1)
            assert torch.equal(out.pose, touts.pose[b, t - 1]), (b, t)
            assert bool(out.accepted) == bool(touts.accepted[b, t - 1])
        for name, x in zip(tpipe.SlamState._fields, state):
            assert torch.equal(x, getattr(tstates, name)[b]), name


def test_fleet_step_stats_and_jax_states_carried_across():
    """JAX fleet states load into the port (a leading robot axis on every
    field); one fleet step on each side from there."""
    jcfg, tcfg = _cut_fleet(jc), _cut_fleet(tc)
    stack = _streams(5, seeds=(7, 11, 3))
    jstep = jax.jit(jfleet.make_fleet_step(jcfg))
    jstates = jfleet.fleet_init(jnp.asarray(stack[:, 0]), jcfg)
    for t in range(1, 4):
        jstates, _, _ = jstep(jstates, jnp.asarray(stack[:, t]), t - 1)
    tstates = state_from_numpy({k: np.asarray(v) for k, v in jstates._asdict().items()}, "cpu")
    assert tstates.pose.shape == (3, 3) and tstates.occ.shape == (3, 384, 384) and tstates.step.dtype == torch.int32
    for k, v in state_to_numpy(tstates).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jstates, k)), err_msg=k)
    js, jo, jstats = jstep(jstates, jnp.asarray(stack[:, 4]), 3)
    ts, to, tstats = tfleet.make_fleet_step(tcfg)(tstates, torch.from_numpy(stack[:, 4]), 3)
    np.testing.assert_array_equal(to.accepted.numpy(), np.asarray(jo.accepted))
    assert np.abs(to.pose.numpy() - np.asarray(jo.pose))[:, :2].max() <= 1.0
    assert abs(float(tstats["mean_rmse"]) - float(jstats["mean_rmse"])) <= 1.0
    assert float(tstats["accept_rate"]) == float(jstats["accept_rate"])
    assert ts.occ is tstates.occ, "the fleet's grid is updated in place"


@pytest.mark.parametrize("side_mm", [11520.0, 12000.0])
def test_who_owns_the_grid(side_mm):
    """`Slam` (the single-robot step) is functional whatever the grid's shape
    (384 x 384, tile-shaped as the fleet preset's, and 400 x 400): a tensor
    kept from an earlier state keeps its values.  The fleet step owns the
    states it is given: their grid is updated in place and handed on."""
    cfg = _cut_fleet(tc, side_mm=side_mm)
    stack = _streams(3)
    slam = port.Slam(cfg, device="cpu")
    slam.add_scan(stack[0, 0])
    kept = slam.state
    copies = [x.clone() for x in kept]
    slam.add_scan(stack[0, 1])
    slam.add_scan(stack[0, 2])
    for name, x, y in zip(tpipe.SlamState._fields, kept, copies):
        assert torch.equal(x, y), f"{name} of a kept state changed"
    assert slam.state.occ is not kept.occ and not torch.equal(slam.state.occ, kept.occ)
    moved = tpipe.update_map(kept, stack[0, 1], np.array([150.0, 0.0, 0.0], np.float32), cfg)
    assert torch.equal(kept.occ, copies[4]) and not torch.equal(moved.occ, kept.occ)

    states = tfleet.fleet_init(torch.from_numpy(stack[:, 0]), cfg)
    grid, before = states.occ, states.occ.clone()
    new, _, _ = tfleet.make_fleet_step(cfg)(states, torch.from_numpy(stack[:, 1]), 0)
    assert new.occ is grid and not torch.equal(grid, before)
    # the same fleet step, asked to leave its input alone, gives the same grids
    states = tfleet.fleet_init(torch.from_numpy(stack[:, 0]), cfg)
    apart, _ = tpipe.make_batched_step(cfg, in_place=False)(states, torch.from_numpy(stack[:, 1]), 0)
    assert torch.equal(states.occ, before) and torch.equal(apart.occ, new.occ)


def test_fleet_init_and_rules():
    cfg = _cut_fleet(tc)
    stack = _streams(2)
    states = tfleet.fleet_init(torch.from_numpy(stack[:, 0]), cfg)
    one = tpipe.init_state(torch.from_numpy(stack[1, 0]), cfg)
    for name, x in zip(tpipe.SlamState._fields, one):
        assert torch.equal(x, getattr(states, name)[1]), name
    # a process without a process group replays the whole fleet alone, as JAX's on one device
    sharded = port.fleet_run_sharded(stack, cfg, device="cpu")
    whole = port.fleet_run_sequence(stack, cfg, device="cpu")
    for got, want in zip((*sharded[0], *sharded[1]), (*whole[0], *whole[1])):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="two scans"):
        port.fleet_run_sequence(stack[:, :1], cfg, device="cpu")


def test_fleet_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.fleet_run_sequence(np.zeros((2, 2, 512, 3), np.float32), tc.FLEET_CONFIG)
