"""Realtime semantics, the GICP rescue, the reseed and the presets: the
port's replay vs the JAX package's ``run_sequence`` on seeded synthetic
warehouse scans, on the CPU.

The JAX side runs ICP and the raster on their fused Pallas paths in interpret
mode, and its rescue through its XLA loop, as its pipeline does.  Parity is
equal accept flags and poses within 2 mm / 2e-3 rad (per-registration
agreement is 1 mm / 2e-3 rad; the map absorbs the differences over a short
replay), not bit equality: the outlier filter and the 50 mm gate are
thresholds, and a value within rounding of one may fall on either side."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_slam_yolo_tpu_torch as port
from icp_slam_yolo_tpu import config as jc
from icp_slam_yolo_tpu.slam import pipeline as jpipe
from icp_slam_yolo_tpu_torch import config as tc
from icp_slam_yolo_tpu_torch.slam import pipeline as tpipe
from test_torch_slam import _compare, _garbage, _scans

torch.set_num_threads(2)


def _cut(m, name, backend, **kw):
    """A preset cut to a 12 m x 12 m map and a 2048-point buffer; the reseed,
    where the preset has one, after 3 rejects instead of 10."""
    base = m.PRESETS[name]
    return base.replace(
        map=m.MapConfig(width_mm=12000.0, height_mm=12000.0),
        map_capacity=2048, local_map_capacity=2048,
        icp=dataclasses.replace(base.icp, backend=backend),
        occupancy=dataclasses.replace(base.occupancy, backend=backend),
        reseed_after_rejects=3 if base.reseed_after_rejects else 0,
    ).replace(**kw)


def test_realtime_preset_replay_matches_jax():
    """The ``realtime`` preset (outlier and duplicate filters, motion model,
    rescue, reseed, maintenance cadence) over 15 scans: 4 good, 4 garbage
    (each rejected by the first pass, so the rescue runs on it; the third
    triggers the reseed), 6 good (the processed-scan count passes 10, so the
    maintenance runs once)."""
    padded, _ = _scans(15, seed=7)
    padded[5:9] = _garbage(padded[5:9])
    jstate, jouts = jpipe.run_sequence(jnp.asarray(padded), _cut(jc, "realtime", "fused"))
    tstate, touts = port.run_sequence(padded, _cut(tc, "realtime", "auto"), device="cpu")
    _compare(jstate, jouts, tstate, touts)
    acc = touts.accepted.numpy()
    assert acc[:4].all() and not acc[4:8].any() and acc[-3:].all()
    ok = np.isfinite(np.asarray(jouts.rmse))
    np.testing.assert_allclose(touts.rmse.numpy()[ok], np.asarray(jouts.rmse)[ok], atol=1.0)
    # iteration counts are not compared: at the preset's tolerance 1e-5 the
    # stopping step hangs on the last digits of the mean error
    np.testing.assert_array_equal(touts.n_points.numpy(), np.asarray(jouts.n_points))
    for name in ("step", "maint_count", "reject_run"):
        assert int(getattr(tstate, name)) == int(getattr(jstate, name)), name
    assert int(tstate.maint_count) == 14


def test_tick_equals_maint_count_when_no_scan_is_skipped():
    """The host ``tick`` (a host branch every 10th step) against the
    per-robot counter on the device (select semantics)."""
    cfg = _cut(tc, "fleet", "auto", icp=dataclasses.replace(tc.FLEET_CONFIG.icp, max_iterations=15))
    padded, _ = _scans(13, seed=3)
    scans = torch.from_numpy(padded)
    step = tpipe.make_step(cfg)
    a = b = tpipe.init_state(scans[0], cfg)
    for t in range(1, 13):
        a, oa = step(a, scans[t], t - 1)
        b, ob = step(b, scans[t])
        assert torch.equal(oa.pose, ob.pose) and bool(oa.accepted) == bool(ob.accepted)
    for name, x, y in zip(tpipe.SlamState._fields, a, b):
        assert torch.equal(x, y), name
    # the maintenance did something at tick 9: a step without it differs
    c = tpipe.init_state(scans[0], cfg)
    for t in range(1, 13):
        c, _ = step(c, scans[t], 0)
    assert int(c.map_valid.sum()) != int(a.map_valid.sum())


def test_too_few_points_skips_the_scan_in_realtime():
    """``enough`` false: nothing but ``step`` moves, the grid included."""
    cfg = _cut(tc, "fleet", "auto", icp=dataclasses.replace(tc.FLEET_CONFIG.icp, max_iterations=5))
    padded, _ = _scans(2, seed=3)
    state = tpipe.init_state(torch.from_numpy(padded[0]), cfg)
    new, out = tpipe.make_step(cfg)(state, torch.zeros((512, 3)))
    assert not bool(out.accepted) and int(out.n_points) == 0
    for name in tpipe.SlamState._fields:
        if name != "step":
            assert torch.equal(getattr(new, name), getattr(state, name)), name
    assert int(new.step) == 1


@pytest.mark.parametrize("name", sorted(tc.PRESETS))
def test_every_preset_builds_a_step(name):
    tpipe.check_supported_config(tc.PRESETS[name])
    assert callable(tpipe.make_step(tc.PRESETS[name]))
    assert callable(tpipe.make_batched_step(tc.PRESETS[name]))
    assert port.Slam(tc.PRESETS[name], device="cpu").cfg == tc.PRESETS[name]


@pytest.mark.parametrize("name", ["offline", "realtime", "robust", "fleet"])
def test_preset_steps_on_the_cpu(name):
    """The preset unchanged but for the map buffer (2048 slots instead of
    24576: the plain ICP on the CPU pays for every slot)."""
    cfg = tc.PRESETS[name].replace(map_capacity=2048, local_map_capacity=2048)
    padded, _ = _scans(3, seed=7)
    slam = port.Slam(cfg, device="cpu")
    for scan in padded:
        out = slam.add_scan(scan[:360])
    assert out["accepted"] and np.isfinite(out["rmse"]) and out["rmse"] < cfg.icp.max_rmse
    assert 200.0 < out["pose"][0] < 400.0  # two steps of 150 mm along x
    assert slam.occupancy().shape == (cfg.map.height_px, cfg.map.width_px)
    assert (slam.occupancy() != 0.5).sum() > 1000 and len(slam.map_points()) > 200
