"""The port's float64 oracle (`icp_slam_yolo_tpu_torch/reference_impl/oracle.py`)
against the JAX package's (`icp_slam_yolo_tpu/reference_impl/oracle.py`):
the same operations in the same order, so every output is held equal bit
for bit (``np.array_equal``), on seeded synthetic warehouse scans and the
bench's wall pair."""

import numpy as np
import pytest

from icp_slam_yolo_tpu import config as jcfg
from icp_slam_yolo_tpu.reference_impl import oracle as joracle
from icp_slam_yolo_tpu_torch import config as tcfg
from icp_slam_yolo_tpu_torch.bench import load_pair
from icp_slam_yolo_tpu_torch.io import scans as scans_io
from icp_slam_yolo_tpu_torch.io.synthetic import synthetic_sequence
from icp_slam_yolo_tpu_torch.reference_impl import oracle as toracle


def _equal(a, b) -> None:
    """Equal bits, recursively through tuples, lists, dicts and states."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (toracle.OracleState, joracle.OracleState)):
        for f in ("pose", "map_xy", "occ", "prev_xy", "reject_run"):
            _equal(getattr(a, f), getattr(b, f))
    elif a is None:
        assert b is None
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y, equal_nan=True)


@pytest.fixture(scope="module")
def scans():
    """12 seeded synthetic warehouse scans (raw polar rows)."""
    return synthetic_sequence(12, seed=7)[0]


@pytest.fixture(scope="module")
def gated(scans):
    return toracle.polar_gate(scans[3], tcfg.OFFLINE_GATE)


def test_icp_on_the_bench_pair():
    src, tgt, _ = load_pair()
    init = np.array([15.0, -10.0, 0.02])
    _equal(toracle.icp(src, tgt, init, tcfg.IcpConfig()), joracle.icp(src, tgt, init, jcfg.IcpConfig()))
    cfg_t, cfg_j = tcfg.IcpConfig(huber_delta_mm=40.0), jcfg.IcpConfig(huber_delta_mm=40.0)
    _equal(toracle.icp(src, tgt, init, cfg_t), joracle.icp(src, tgt, init, cfg_j))


@pytest.mark.parametrize("voxel", [20.0, 30.0, 60.0])
def test_voxel_downsample(gated, voxel):
    _equal(toracle.voxel_downsample(gated, voxel), joracle.voxel_downsample(gated, voxel))
    _equal(toracle.voxel_downsample(gated[:0], voxel), joracle.voxel_downsample(gated[:0], voxel))


@pytest.mark.parametrize("gate", ["OFFLINE_GATE", "REALTIME_GATE"])
def test_polar_gate_and_se2(scans, gate):
    xy_t = toracle.polar_gate(scans[5], getattr(tcfg, gate))
    _equal(xy_t, joracle.polar_gate(scans[5], getattr(jcfg, gate)))
    pose = np.array([120.0, -45.0, 0.3])
    _equal(toracle.se2_apply(pose, xy_t), joracle.se2_apply(pose, xy_t))
    _equal(toracle.se2_compose(pose, pose[::-1]), joracle.se2_compose(pose, pose[::-1]))


def test_io_scans_takes_the_oracles_helpers():
    """`io/scans.polar_gate` and `se2_apply` are the oracle's (one copy in the port)."""
    assert scans_io.polar_gate is toracle.polar_gate and scans_io.se2_apply is toracle.se2_apply


def test_nn_and_best_fit(scans, gated):
    other = toracle.polar_gate(scans[4], tcfg.OFFLINE_GATE)
    _equal(toracle.nn_bruteforce(gated, other), joracle.nn_bruteforce(gated, other))
    dist, idx = toracle.nn_bruteforce(gated, other)
    w = (dist < 200.0).astype(np.float64)
    _equal(toracle.best_fit_se2(gated, other[idx], w), joracle.best_fit_se2(gated, other[idx], w))


@pytest.mark.parametrize("cfg_name", ["OFFLINE_CONFIG", "REALTIME_CONFIG", "REALTIME_1_CONFIG"])
def test_update_occupancy_and_prune(gated, cfg_name):
    ct, cj = getattr(tcfg, cfg_name), getattr(jcfg, cfg_name)
    robot = np.array([250.0, -130.0])
    occ0 = np.full((ct.map.height_px, ct.map.width_px), 0.5)
    occ_t = toracle.update_occupancy(occ0, gated, robot, ct.map, ct.occupancy)
    occ_j = joracle.update_occupancy(occ0, gated, robot, cj.map, cj.occupancy)
    _equal(occ_t, occ_j)
    occ_t = toracle.update_occupancy(occ_t, gated + 35.0, robot + 40.0, ct.map, ct.occupancy)
    occ_j = joracle.update_occupancy(occ_j, gated + 35.0, robot + 40.0, cj.map, cj.occupancy)
    _equal(occ_t, occ_j)
    pts = np.concatenate([gated, gated * 0.5, gated + 3000.0])
    _equal(toracle.prune_keep_mask(pts, occ_t, robot, ct.map, ct.occupancy),
           joracle.prune_keep_mask(pts, occ_j, robot, cj.map, cj.occupancy))
    _equal(toracle.occupancy_keep_mask(pts, occ_t, ct.map, ct.occupancy.free_threshold),
           joracle.occupancy_keep_mask(pts, occ_j, cj.map, cj.occupancy.free_threshold))
    _equal(toracle.world_to_px(pts, ct.map), joracle.world_to_px(pts, cj.map))


@pytest.mark.parametrize("line", [(0, 0, 9, 4), (5, 5, -3, 17), (2, 8, 2, 8), (-4, 3, 6, -3)])
def test_bresenham(line):
    assert toracle.bresenham(*line) == joracle.bresenham(*line)


@pytest.mark.parametrize("k, ratio", [(30, 1.5), (5, 0.5)])
def test_statistical_outlier_keep(gated, k, ratio):
    _equal(toracle.statistical_outlier_keep(gated, k, ratio, 512),
           joracle.statistical_outlier_keep(gated, k, ratio, 512))
    _equal(toracle.statistical_outlier_keep(gated[:1], k, ratio, 512),
           joracle.statistical_outlier_keep(gated[:1], k, ratio, 512))


def test_run_sequence_offline(scans):
    got = toracle.run_sequence(scans, tcfg.OFFLINE_CONFIG)
    want = joracle.run_sequence(scans, jcfg.OFFLINE_CONFIG)
    _equal(got, want)
    assert got[3].mean() > 0.9  # the replay tracks: the comparison is not of rejects alone


def test_run_sequence_realtime(scans):
    got = toracle.run_sequence_realtime(scans, tcfg.REALTIME_CONFIG)
    want = joracle.run_sequence_realtime(scans, jcfg.REALTIME_CONFIG)
    _equal(got, want)
    assert got[3].mean() > 0.9


def test_step_and_reseed_with_garbage(scans):
    """Rejected scans (ranges drawn at random) through both copies' steps,
    realtime semantics with the reseed after 2 rejects."""
    garbage = scans.copy()
    garbage[..., 2] = np.where(garbage[..., 2] > 0, np.random.default_rng(3).uniform(1200.0, 8000.0,
                                                                                   garbage[..., 2].shape), 0.0)
    seq = np.concatenate([scans[:4], garbage[4:7], scans[7:9]])
    ct, cj = tcfg.REALTIME_CONFIG.replace(reseed_after_rejects=2), jcfg.REALTIME_CONFIG.replace(reseed_after_rejects=2)
    got, want = toracle.run_sequence_realtime(seq, ct), joracle.run_sequence_realtime(seq, cj)
    _equal(got, want)
    assert not got[3].all()
    st_t, st_j = toracle.init_state(seq[0], ct), joracle.init_state(seq[0], cj)
    _equal(toracle.step(st_t, seq[5], ct), joracle.step(st_j, seq[5], cj))
