"""The port's fusion (`fusion/landmarks.py`) against the JAX package's, and
a few ticks of the fused SLAM + detect loop (``BASELINE.json``
configuration 4) on the CPU against the same ticks through the JAX
package: its `Slam`, `Detector.detect_pair`, the server's fusion step
(`serve/state.py` ``on_pair``: keypoint or box corners, `pallet_alignment`,
`project_detection`, `LandmarkMap.insert`).

Tolerances: the frame transforms 1e-9 (float64 host math on both sides);
a projected landmark 1e-4 relative (float32 alignment); the ticks' poses as
the SLAM replay tests (2 mm, 2e-3 rad) and their landmarks 1e-3 relative
(boxes agree to 0.02 px in the frame, `test_torch_detect.py`)."""

import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import icp_slam_yolo_tpu_torch as port
from icp_slam_yolo_tpu import config as jc
from icp_slam_yolo_tpu.fusion import landmarks as jland
from icp_slam_yolo_tpu.models import detect as jdetect
from icp_slam_yolo_tpu.perception.stereo import pallet_alignment as jalign
from icp_slam_yolo_tpu.slam import api as japi
from icp_slam_yolo_tpu_torch import config as tc
from icp_slam_yolo_tpu_torch.fusion import landmarks as tland
from icp_slam_yolo_tpu_torch.perception.stereo import pallet_alignment as talign

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pallet_corners(rng):
    """Pixel corners of a pallet face in both eyes (f 381, B 26 mm)."""
    x, z, yaw = rng.uniform(-400, 400), rng.uniform(700, 2500), rng.uniform(-0.5, 0.5)
    xs = np.array([-55.0, 55, 55, -55])
    p = np.stack([x + xs * np.cos(yaw), np.array([-50.0, -50, 50, 50]), z + xs * np.sin(yaw)], axis=1)

    def project(shift):
        return np.stack([(p[:, 0] - shift) * 381.0 / p[:, 2] + 320.0, p[:, 1] * 381.0 / p[:, 2] + 240.0], axis=1)
    return project(0.0), project(26.0)


@pytest.mark.parametrize("seed", range(3))
def test_frame_transforms_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        p = tuple(rng.uniform(-3000, 3000, 3))
        mf, ml = rng.uniform(-500, 500, 2)
        assert tland.camera_to_robot(p, mf, ml) == jland.camera_to_robot(p, mf, ml)
        pose, pt = (*rng.uniform(-5000, 5000, 2), rng.uniform(-math.pi, math.pi)), tuple(rng.uniform(-3000, 3000, 2))
        np.testing.assert_allclose(tland.robot_to_world(pose, pt), jland.robot_to_world(pose, pt), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("seed", range(4))
def test_project_detection_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    cl, cr = _pallet_corners(rng)
    pose = (rng.uniform(-5000, 5000), rng.uniform(-5000, 5000), rng.uniform(-math.pi, math.pi))
    kw = dict(class_id=int(rng.integers(0, 3)), score=float(rng.random()), mount_forward_mm=120.0, mount_left_mm=-30.0)
    t, j = tland.project_detection(pose, cl, cr, **kw), jland.project_detection(pose, cl, cr, **kw)
    np.testing.assert_allclose(t.xy_mm, j.xy_mm, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(t.yaw_rad, j.yaw_rad, rtol=1e-4, atol=1e-5)
    assert (t.class_id, t.score, t.n_obs) == (j.class_id, j.score, j.n_obs)
    again = tland.project_detection(pose, cl, cr, alignment=talign(cl, cr), **kw)
    assert again == t


def _same_maps(t: tland.LandmarkMap, j: jland.LandmarkMap, rtol: float = 1e-9):
    assert len(t.landmarks) == len(j.landmarks)
    for a, b in zip(t.landmarks, j.landmarks):
        np.testing.assert_allclose(a.xy_mm, b.xy_mm, rtol=rtol, atol=rtol)
        np.testing.assert_allclose(a.yaw_rad, b.yaw_rad, rtol=rtol, atol=rtol)
        assert (a.class_id, a.n_obs) == (b.class_id, b.n_obs)
        np.testing.assert_allclose(a.score, b.score, rtol=rtol)


def test_landmark_map_merges_and_markers_match_jax(rng):
    """Inserts within 500 mm of a same-class landmark merge (a running mean,
    the best score), another class or farther away add one; the pixel
    markers of both packages' map configurations agree."""
    tmap, jmap = tland.LandmarkMap(), jland.LandmarkMap()
    centres = rng.uniform(-6000, 6000, (4, 2))
    for _ in range(40):
        c = centres[rng.integers(0, 4)] + rng.normal(0, 250, 2)
        kw = dict(xy_mm=(float(c[0]), float(c[1])), yaw_rad=float(rng.uniform(-1, 1)), class_id=int(rng.integers(0, 2)),
                  score=float(rng.random()))
        assert tmap.insert(tland.Landmark(**kw)) == jmap.insert(jland.Landmark(**kw))
    _same_maps(tmap, jmap)
    assert 4 <= len(tmap.landmarks) < 40 and max(lm.n_obs for lm in tmap.landmarks) > 1
    for mc_t, mc_j in ((tc.MapConfig(), jc.MapConfig()),
                       (tc.MapConfig(width_mm=12000.0, height_mm=9000.0, resolution_mm_per_px=20.0),
                        jc.MapConfig(width_mm=12000.0, height_mm=9000.0, resolution_mm_per_px=20.0))):
        assert tmap.to_pixel_markers(mc_t) == jmap.to_pixel_markers(mc_j)
    small_t, small_j = tland.LandmarkMap(100.0), jland.LandmarkMap(100.0)
    for x in (0.0, 80.0, 150.0, 260.0):
        lm = dict(xy_mm=(x, 0.0), yaw_rad=0.0, class_id=0, score=0.5)
        assert small_t.insert(tland.Landmark(**lm)) == small_j.insert(jland.Landmark(**lm))
    _same_maps(small_t, small_j)


def _jax_on_pair(out1, out2, pose, landmarks):
    """The JAX server's fusion step after ``detect_pair`` (the body of
    ``on_pair`` in ``serve/state.py``, without the publishing)."""
    if not len(out1["boxes"]) or not len(out2["boxes"]):
        return None
    kpts_ok = ("keypoints" in out1 and "keypoints" in out2
               and float(np.min(out1["keypoints"][0][:, 2])) >= 0.5
               and float(np.min(out2["keypoints"][0][:, 2])) >= 0.5)
    if kpts_ok:
        c1 = np.asarray(out1["keypoints"][0][:, :2], np.float64)
        c2 = np.asarray(out2["keypoints"][0][:, :2], np.float64)
    else:
        b1, b2 = out1["boxes"][0], out2["boxes"][0]
        c1 = np.array([[b1[0], b1[1]], [b1[2], b1[1]], [b1[2], b1[3]], [b1[0], b1[3]]])
        c2 = np.array([[b2[0], b2[1]], [b2[2], b2[1]], [b2[2], b2[3]], [b2[0], b2[3]]])
    align = jalign(c1, c2)
    idx = landmarks.insert(jland.project_detection(tuple(map(float, pose)), c1, c2, score=float(out1["scores"][0]),
                                                   alignment=align))
    return align, idx


@pytest.mark.parametrize("case", ["boxes", "keypoints", "one occluded keypoint", "an eye sees nothing"])
def test_fuse_stereo_pair_matches_the_jax_server_step(case, rng):
    """Keypoint corners when all four of both eyes have visibility >= 0.5,
    the first box's corners otherwise, nothing when an eye is empty."""
    tmap, jmap = tland.LandmarkMap(), jland.LandmarkMap()
    for k in range(5):
        cl, cr = _pallet_corners(rng)
        outs = []
        for c in (cl, cr):
            box = np.array([c[:, 0].min(), c[:, 1].min(), c[:, 0].max(), c[:, 1].max()], np.float32) + rng.normal(0, 2, 4)
            out = {"boxes": np.stack([box, box + 30]).astype(np.float32), "scores": np.array([0.9, 0.4], np.float32),
                   "classes": np.zeros(2, np.int32)}
            if case != "boxes":
                vis = np.array([0.9, 0.8, 0.7, 0.3 if case == "one occluded keypoint" and k % 2 else 0.6])
                out["keypoints"] = np.stack([np.concatenate([c, vis[:, None]], axis=1)] * 2).astype(np.float32)
            if case == "an eye sees nothing" and c is cr:
                out = {key: v[:0] for key, v in out.items()}
            outs.append(out)
        pose = (rng.uniform(-3000, 3000), rng.uniform(-3000, 3000), rng.uniform(-3, 3))
        t = tland.fuse_stereo_pair(*outs, pose, tmap)
        j = _jax_on_pair(*outs, pose, jmap)
        assert (t is None) == (j is None) == (case == "an eye sees nothing")
        if t is not None:
            assert t[1] == j[1]
            for name in t[0]._fields:
                np.testing.assert_allclose(float(getattr(t[0], name)), float(getattr(j[0], name)), rtol=1e-5, atol=1e-5)
    _same_maps(tmap, jmap, rtol=1e-4)


def test_ticks_match_jax():
    """Six ticks of the fused loop on the CPU: the port (`chip_smoke.tick`:
    `Slam.add_scan`, `Detector.detect_pair` with the trained v12 weights at
    a 64 px input on the fused path's plain versions, `fuse_stereo_pair`)
    against the same ticks through the JAX package, on a 12 m map with 2048
    map slots and seeded synthetic scans and stereo frames."""
    def cfg(m, backend):
        return m.OFFLINE_CONFIG.replace(
            map=m.MapConfig(width_mm=12000.0, height_mm=12000.0), map_capacity=2048, local_map_capacity=2048,
            icp=dataclasses.replace(m.OFFLINE_CONFIG.icp, rescue_estimator="", backend=backend),
            occupancy=dataclasses.replace(m.OFFLINE_CONFIG.occupancy, backend=backend))

    path = os.path.join(REPO, chip_smoke.TICK_CHECKPOINT)
    kw = dict(conf_threshold=1e-6, img_size=64)
    tdet = port.detector_from_checkpoint(path, compute_dtype=torch.float32, pallas_convs=True, device="cpu", **kw)
    jdet = jdetect.detector_from_checkpoint(path, compute_dtype=jnp.float32, **kw)
    assert tdet.model.family == "v12" and tdet.model.fused
    tslam, jslam = port.Slam(cfg(tc, "auto"), device="cpu"), japi.Slam(cfg(jc, "fused"))
    tmap, jmap = tland.LandmarkMap(), jland.LandmarkMap()
    scans, _ = chip_smoke.synthetic_sequence(7, seed=5)
    fused = 0
    for k, scan in enumerate(scans):
        left, right = chip_smoke.stereo_pair(60 + k)
        step, got = chip_smoke.tick(tslam, tdet, tmap, scan, left, right)
        jstep = jslam.add_scan(scan)
        want = _jax_on_pair(*jdet.detect_pair(left, right), jslam.pose, jmap)
        assert step["accepted"] == bool(jstep["accepted"])
        dp = np.abs(np.asarray(tslam.pose) - np.asarray(jslam.pose))
        assert dp[:2].max() <= 2.0 and dp[2] <= 2e-3, dp
        assert (got is None) == (want is None)
        fused += got is not None
    assert fused == len(scans)
    _same_maps(tmap, jmap, rtol=1e-3)
