"""The port's perception geometry (`perception/stereo.py`,
`perception/obb_pose.py`) against the JAX package's, on seeded stereo
pallet corners.

float32 on both sides.  Tolerances: the triangulation and the alignment
readout 1e-5 relative (the same few float32 operations, in another order);
the pose from one homography 1e-4 (SVDs, LAPACK's against XLA's), the
homography itself compared up to scale and sign (the DLT's null vector has
neither) at 1e-4 of its scale; the integer codes exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_slam_yolo_tpu.perception import obb_pose as jpose
from icp_slam_yolo_tpu.perception import stereo as jstereo
from icp_slam_yolo_tpu_torch.perception import obb_pose as tpose
from icp_slam_yolo_tpu_torch.perception import stereo as tstereo

F, CX, CY, B = 381.0, 320.0, 240.0, 26.0
K = np.array([[F, 0, CX], [0, F, CY], [0, 0, 1]], np.float32)


def _project(p3d, shift_x=0.0):
    p = np.asarray(p3d, np.float64)
    return np.stack([(p[:, 0] - shift_x) * F / p[:, 2] + CX, p[:, 1] * F / p[:, 2] + CY], axis=1)


def _pallet(rng):
    """A yawed, offset 110 x 100 mm pallet face: its corners in camera mm
    and in both views' pixels (tl, tr, br, bl)."""
    yaw = rng.uniform(-0.6, 0.6)
    cx, cz = rng.uniform(-500, 500), rng.uniform(600, 2500)
    xs, ys = np.array([-55.0, 55, 55, -55]), np.array([-50.0, -50, 50, 50])
    pts = np.stack([cx + xs * np.cos(yaw), ys + rng.uniform(-30, 30), cz + xs * np.sin(yaw)], axis=1)
    left = _project(pts) + rng.normal(0, 0.3, (4, 2))
    return pts, left.astype(np.float32), (_project(pts, B) + rng.normal(0, 0.3, (4, 2))).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_stereo_to_3d_and_orientation_match_jax(seed):
    pts, left, right = _pallet(np.random.default_rng(seed))
    right[1, 0] = left[1, 0]  # a zero disparity: 1e-6 on both sides
    j3 = np.asarray(jstereo.stereo_to_3d(left, right))
    t3 = tstereo.stereo_to_3d(left, right)
    assert t3.dtype == torch.float32
    np.testing.assert_allclose(t3.numpy(), j3, rtol=1e-5)
    jn, jy, jd = jstereo.pallet_orientation_and_distance(jnp.asarray(pts, jnp.float32))
    tn, ty, td = tstereo.pallet_orientation_and_distance(pts.astype(np.float32))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose([float(ty), float(td)], [float(jy), float(jd)], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_pallet_alignment_matches_jax(seed):
    _, left, right = _pallet(np.random.default_rng(10 + seed))
    j = jstereo.pallet_alignment(left, right)
    t = tstereo.pallet_alignment(left, right)
    assert isinstance(t, tstereo.PalletAlignment) and t._fields == j._fields
    for name in ("horizontal_angle_rad", "lateral_offset_mm", "yaw_rad", "distance_mm"):
        np.testing.assert_allclose(float(getattr(t, name)), float(getattr(j, name)), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert int(t.direction) == int(j.direction) and t.direction.dtype == torch.int32


def test_alignment_direction_codes_and_constants():
    """Left, centre and right of the +-5 degree band, and the constants."""
    codes = []
    for x in (-400.0, 0.0, 400.0):
        pts = np.array([[x - 55, -50, 1000], [x + 55, -50, 1000], [x + 55, 50, 1000], [x - 55, 50, 1000]])
        t = tstereo.pallet_alignment(_project(pts), _project(pts, B))
        codes.append(int(t.direction))
        assert int(jstereo.pallet_alignment(_project(pts), _project(pts, B)).direction) == codes[-1]
    assert codes == [-1, 0, 1]
    assert (tstereo.PALLET_WIDTH_MM, tstereo.LATERAL_OFFSET_BIAS, tstereo.ALIGN_DEG_THRESHOLD) == (
        jstereo.PALLET_WIDTH_MM, jstereo.LATERAL_OFFSET_BIAS, jstereo.ALIGN_DEG_THRESHOLD)


@pytest.mark.parametrize("seed", range(4))
def test_sort_corners_and_object_pose_match_jax(seed):
    rng = np.random.default_rng(20 + seed)
    _, left, _ = _pallet(rng)
    coords = left[rng.permutation(4)]
    np.testing.assert_array_equal(tpose.sort_corners(coords).numpy(), np.asarray(jpose.sort_corners(coords)))
    for width in (640.0, 1280.0, 300.0):
        j = jpose.analyze_object_pose(jnp.asarray(coords), width)
        t = tpose.analyze_object_pose(coords, width)
        assert (int(t.position), int(t.rotation)) == (int(j.position), int(j.rotation))
        np.testing.assert_allclose(float(t.roll_deg), float(j.roll_deg), rtol=1e-5, atol=1e-4)


def _face(rng):
    """Pixels [tl, tr, br, bl] of the 110 x 15 mm pallet face template
    ``[(0, 15), (110, 15), (110, 0), (0, 0)]`` seen through a seeded pose
    (yawed and pitched a little, 0.5-2 m ahead), with 0.2 px of noise."""
    a, b = rng.uniform(-0.5, 0.5), rng.uniform(-0.2, 0.2)
    ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    t = np.array([rng.uniform(-300, 300), rng.uniform(-100, 100), rng.uniform(500, 2000)])
    obj = np.array([[0.0, 15, 0], [110, 15, 0], [110, 0, 0], [0, 0, 0]])
    return (_project(obj @ (ry @ rx).T + t) + rng.normal(0, 0.2, (4, 2))).astype(np.float32)


def _normalised(h):
    h = np.asarray(h, np.float64)
    h = h / np.linalg.norm(h)
    return h * np.sign(h.flat[np.argmax(np.abs(h))])


@pytest.mark.parametrize("seed", range(4))
def test_homography_up_to_scale_and_sign(seed):
    left = _face(np.random.default_rng(30 + seed))
    obj = np.array([[0.0, 15.0], [110.0, 15.0], [110.0, 0.0], [0.0, 0.0]], np.float32)
    j = jpose._homography_dlt(jnp.asarray(obj), jnp.asarray(left))
    t = tpose._homography_dlt(torch.from_numpy(obj), torch.from_numpy(left))
    np.testing.assert_allclose(_normalised(t.numpy()), _normalised(j), atol=1e-4)


@pytest.mark.parametrize("seed", range(4))
def test_pose_and_projection_match_jax(seed, monkeypatch):
    """`estimate_3d_pose` and `mono_pose_from_corners` from one homography
    (both packages' `_homography_dlt` replaced by the float64 DLT rounded
    to float32: 1e-4 relative, 1e-3 absolute), and `project_points`
    through the pose.  The pose of a 110 x 15 mm face is ill-conditioned in
    its homography: float32 DLTs that agree to 1e-5 of their scale give
    rotations 0.017 apart, so the unreplaced pipelines are held to 0.05 on
    R and 3 degrees."""
    left = _face(np.random.default_rng(40 + seed))
    obj = torch.tensor([[0.0, 15], [110, 15], [110, 0], [0, 0]], dtype=torch.float64)
    free = (tpose.estimate_3d_pose(left, (110.0, 15.0), K), jpose.estimate_3d_pose(jnp.asarray(left), (110.0, 15.0),
                                                                                   jnp.asarray(K)))
    np.testing.assert_allclose(free[0][0].numpy(), np.asarray(free[1][0]), atol=0.05)
    np.testing.assert_allclose(free[0][2].numpy(), np.asarray(free[1][2]), atol=3.0)
    h = tpose._homography_dlt(obj, torch.tensor(left, dtype=torch.float64)).float()
    monkeypatch.setattr(tpose, "_homography_dlt", lambda *_: h)
    monkeypatch.setattr(jpose, "_homography_dlt", lambda *_: jnp.asarray(h.numpy()))
    jr, jt, je = jpose.estimate_3d_pose(jnp.asarray(left), (110.0, 15.0), jnp.asarray(K))
    tr, tt, te = tpose.estimate_3d_pose(left, (110.0, 15.0), K)
    for got, want in ((tr, jr), (tt, jt), (te, je)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)
    jm = jpose.mono_pose_from_corners(jnp.asarray(left), jnp.asarray(K))
    tm = tpose.mono_pose_from_corners(left, K)
    assert set(tm) == set(jm)
    for key in tm:
        np.testing.assert_allclose(np.asarray(tm[key], np.float64), np.asarray(jm[key], np.float64), rtol=1e-4,
                                   atol=1e-3, err_msg=key)
    axes = np.array([[0.0, 0, 0], [50, 0, 0], [0, 50, 0], [0, 0, 50]], np.float32)
    np.testing.assert_allclose(tpose.project_points(axes, tr, tt, K).numpy(),
                               np.asarray(jpose.project_points(jnp.asarray(axes), jr, jt, jnp.asarray(K))),
                               rtol=1e-4, atol=1e-2)
    assert tpose.POSITION_NAMES == jpose.POSITION_NAMES and tpose.ROTATION_NAMES == jpose.ROTATION_NAMES
