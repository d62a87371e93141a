"""PyTorch port vs the JAX package: config copy, scan padding, geometry,
Kabsch and voxel/compact.  Inputs come from numpy seeds and go through both
sides; everything runs on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_slam_yolo_tpu import config as jcfg
from icp_slam_yolo_tpu.io import scans as jscans
from icp_slam_yolo_tpu.ops import geometry as jgeo
from icp_slam_yolo_tpu.ops import kabsch as jkabsch
from icp_slam_yolo_tpu.ops import voxel as jvoxel
from icp_slam_yolo_tpu_torch import config as tcfg
from icp_slam_yolo_tpu_torch.io import scans as tscans
from icp_slam_yolo_tpu_torch.ops import geometry as tgeo
from icp_slam_yolo_tpu_torch.ops import kabsch as tkabsch
from icp_slam_yolo_tpu_torch.ops import voxel as tvoxel

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _random_scan(rng, n=400, n_max=512):
    scan = np.zeros((n_max, 3), np.float32)
    scan[:n, 0] = rng.uniform(0, 60, n)
    scan[:n, 1] = rng.uniform(0, 360, n)
    scan[:n, 2] = rng.uniform(-500, 12000, n)
    return scan


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_equal_field_for_field(name):
    assert dataclasses.asdict(tcfg.PRESETS[name]) == dataclasses.asdict(jcfg.PRESETS[name])


def test_constants_and_defaults_equal():
    assert dataclasses.asdict(tcfg.SlamConfig()) == dataclasses.asdict(jcfg.SlamConfig())
    for k in ("STEREO_F", "STEREO_CX", "STEREO_CY", "STEREO_BASELINE",
              "CAMERA_TRIGGER_DISTANCE_MM", "MAP_MAINTENANCE_INTERVAL", "ROBOT_AXIS_LENGTH_MM"):
        assert getattr(tcfg, k) == getattr(jcfg, k)
    with pytest.raises(ValueError):
        tcfg.OccupancyConfig(window_px=140, max_ray_px=140)


def test_pad_and_collate_equal(rng):
    raw = [rng.uniform(0, 100, (m, 3)) for m in (5, 300, 700)]
    np.testing.assert_array_equal(tscans.collate(raw, 512), jscans.collate(raw, 512))
    np.testing.assert_array_equal(tscans.pad_scan(raw[1], 256), jscans.pad_scan(raw[1], 256))


@pytest.mark.parametrize("end", [None, 9])
def test_load_sequence_equal(tmp_path, rng, end):
    """Both naming schemes, a gap in the numbering and a scan longer than
    ``n_max``: the same files, order, padding and counts as the JAX loader."""
    for i, name in ((1, "Scan_data_1.npy"), (2, "Scan_data_2.npy"), (4, "scan_data_4.npy"), (7, "scan_7.npy")):
        np.save(tmp_path / name, rng.uniform(0, 100, (50 * i + 40, 3)))
    t_scans, t_counts, t_paths = tscans.load_sequence(str(tmp_path), 1, end, n_max=256)
    j_scans, j_counts, j_paths = jscans.load_sequence(str(tmp_path), 1, end, n_max=256)
    assert t_paths == j_paths and len(t_paths) == 4
    np.testing.assert_array_equal(t_counts, j_counts)
    np.testing.assert_array_equal(t_scans, j_scans)


@pytest.mark.parametrize("preset", ["offline", "realtime", "realtime_b", "realtime_1"])
def test_polar_to_cartesian(rng, preset):
    """Gates exact; coordinates to 2 ulp of 10 m (the two CPU libms' sin/cos
    differ in the last bit)."""
    scan = _random_scan(rng)
    gate = jcfg.PRESETS[preset].gate
    jxy, jv = jgeo.polar_to_cartesian(jnp.asarray(scan), gate)
    txy, tv = tgeo.polar_to_cartesian(_t(scan), tcfg.PRESETS[preset].gate)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), rtol=0, atol=2e-3)


def test_se2_ops(rng):
    """SE(2) helpers to float32 rounding (<= 1e-3 mm at 10 m)."""
    pts = rng.uniform(-8000, 8000, (64, 2)).astype(np.float32)
    for _ in range(5):
        a = np.array([*rng.uniform(-3000, 3000, 2), rng.uniform(-3, 3)], np.float32)
        b = np.array([*rng.uniform(-3000, 3000, 2), rng.uniform(-3, 3)], np.float32)
        ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
        np.testing.assert_allclose(tgeo.se2_apply(ta, _t(pts)).numpy(),
                                   np.asarray(jgeo.se2_apply(ja, jnp.asarray(pts))), atol=2e-3)
        np.testing.assert_allclose(tgeo.se2_compose(ta, tb).numpy(),
                                   np.asarray(jgeo.se2_compose(ja, jb)), atol=1e-3)
        np.testing.assert_allclose(tgeo.se2_inverse(ta).numpy(),
                                   np.asarray(jgeo.se2_inverse(ja)), atol=1e-3)
        np.testing.assert_allclose(tgeo.se2_extrapolate(ta, tb).numpy(),
                                   np.asarray(jgeo.se2_extrapolate(ja, jb)), atol=2e-3)
        np.testing.assert_allclose(tgeo.se2_to_mat44(ta).numpy(),
                                   np.asarray(jgeo.se2_to_mat44(ja)), atol=1e-6)
        np.testing.assert_allclose(tgeo.se2_rotation(ta).numpy(),
                                   np.asarray(jgeo.se2_rotation(ja)), atol=1e-6)
    valid = rng.random(64) < 0.5
    np.testing.assert_allclose(tgeo.masked_mean(_t(pts), _t(valid)).numpy(),
                               np.asarray(jgeo.masked_mean(jnp.asarray(pts), jnp.asarray(valid))),
                               atol=1e-3)
    assert tgeo.masked_mean(_t(pts), torch.zeros(64, dtype=torch.bool)).abs().max() == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_fit_se2(seed):
    """Closed-form Kabsch: angle to 1e-6 rad, translation to 1e-3 mm."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-5000, 5000, (200, 2)).astype(np.float32)
    dst = (src + rng.normal(0, 30, src.shape)).astype(np.float32)
    w = (rng.random(200) < 0.7).astype(np.float32)
    jt, jtr = jkabsch.best_fit_se2(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    tt, ttr = tkabsch.best_fit_se2(_t(src), _t(dst), _t(w))
    assert abs(float(tt) - float(jt)) < 1e-6
    np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), atol=1e-3)
    zt, ztr = tkabsch.best_fit_se2(_t(src), _t(dst), torch.zeros(200))
    assert float(zt) == 0.0 and ztr.abs().max() == 0


def _rot(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def test_svd_matches_se2_and_jax(rng):
    """`tests/test_kabsch.py`'s planar case: the SVD solve recovers the
    transform, as JAX's does (R to 1e-4, t to 0.5 mm)."""
    src = rng.normal(size=(80, 2)) * 1500
    theta, t = 1.2, np.array([500.0, 100.0])
    dst = src @ _rot(theta).T + t
    a, b = (src * 1e-3).astype(np.float32), (dst * 1e-3).astype(np.float32)
    r, tt = tkabsch.best_fit_transform_svd(_t(a), _t(b))
    jr, jtt = jkabsch.best_fit_transform_svd(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(r.numpy(), _rot(theta), atol=1e-4)
    np.testing.assert_allclose(tt.numpy() * 1e3, t, atol=0.5)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jtt), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_svd_reflection_fix_as_jax(seed):
    """`tests/test_kabsch.py`'s noisy correspondences: a proper rotation
    (det > 0.99), the JAX solve's R and t."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(30, 2)).astype(np.float32)
    dst = rng.normal(size=(30, 2)).astype(np.float32)
    r, tt = tkabsch.best_fit_transform_svd(_t(src), _t(dst))
    jr, jtt = jkabsch.best_fit_transform_svd(jnp.asarray(src), jnp.asarray(dst))
    assert float(torch.linalg.det(r)) > 0.99
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jtt), atol=1e-4)


def test_weighted_3d_svd_and_transform_points(rng):
    """Three dimensions with weights (outliers weighted out), and
    `transform_points` against JAX's."""
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    t = np.array([0.3, -1.2, 0.7])
    src = rng.normal(size=(50, 3)).astype(np.float32)
    dst = (src @ q.T + t).astype(np.float32)
    dst[40:] += rng.normal(size=(10, 3)).astype(np.float32) * 5
    w = np.concatenate([np.ones(40), np.zeros(10)]).astype(np.float32)
    r, tt = tkabsch.best_fit_transform_svd(_t(src), _t(dst), _t(w))
    jr, jtt = jkabsch.best_fit_transform_svd(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    np.testing.assert_allclose(r.numpy(), q, atol=1e-4)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jtt), atol=1e-5)
    moved = tgeo.transform_points(_t(src), r, tt).numpy()
    np.testing.assert_allclose(moved, np.asarray(jgeo.transform_points(jnp.asarray(src), jr, jtt)), atol=1e-4)
    np.testing.assert_allclose(moved[:40], dst[:40], atol=1e-4)


def test_voxel_keys_exact(rng):
    xy = rng.uniform(-200000, 200000, (512, 2)).astype(np.float32)
    valid = rng.random(512) < 0.8
    np.testing.assert_array_equal(
        tvoxel.voxel_keys(_t(xy), _t(valid), 20.0).numpy(),
        np.asarray(jvoxel.voxel_keys(jnp.asarray(xy), jnp.asarray(valid), 20.0)),
    )


@pytest.mark.parametrize("n,voxel", [(512, 20.0), (512, 30.0), (2560, 20.0)])
def test_voxel_downsample(n, voxel):
    """Same voxels, same packing order; means to 1e-4 mm plus 2 ulp of the
    coordinate (1 ulp is 1e-3 mm at 9 m): the split prefix sums add in
    another order than XLA's scan, and on the card cumsum's order differs
    again, with the same bound."""
    rng = np.random.default_rng(n + int(voxel))
    xy = rng.uniform(-9000, 9000, (n, 2)).astype(np.float32)
    xy[: n // 4] = xy[n // 4: n // 2] + rng.normal(0, 5, (n // 4, 2))  # shared voxels
    valid = rng.random(n) < 0.85
    jxy, jv = jvoxel.voxel_downsample(jnp.asarray(xy), jnp.asarray(valid), voxel)
    txy, tv = tvoxel.voxel_downsample(_t(xy), _t(valid), voxel)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), rtol=2.4e-7, atol=1e-4)


@pytest.mark.parametrize("capacity", [300, 512, 700])
def test_compact_exact(rng, capacity):
    xy = rng.uniform(-9000, 9000, (512, 2)).astype(np.float32)
    valid = rng.random(512) < 0.5
    jxy, jv = jvoxel.compact(jnp.asarray(xy), jnp.asarray(valid), capacity)
    txy, tv = tvoxel.compact(_t(xy), _t(valid), capacity)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(txy.numpy(), np.asarray(jxy))
