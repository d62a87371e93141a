"""The whole slice: the port's SLAM step and replay vs the JAX package's, on
seeded synthetic warehouse scans (the reference dataset is not in the
repository), plus state carried across, the device rule and the import rule.

The JAX side runs ICP and the raster on their fused Pallas paths in
interpret mode (``backend="fused"``), the semantics the port's kernels
carry; one 14-scan replay takes a few seconds there.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import icp_slam_yolo_tpu_torch as port
from icp_slam_yolo_tpu import config as jc
from icp_slam_yolo_tpu.slam import api as japi
from icp_slam_yolo_tpu.slam import pipeline as jpipe
from icp_slam_yolo_tpu_torch import config as tc
from icp_slam_yolo_tpu_torch.convert import state_from_numpy, state_to_numpy
from icp_slam_yolo_tpu_torch.slam import pipeline as tpipe

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# pose tolerance of the replay: per-registration agreement is <= 1 mm /
# 2e-3 rad (test_torch_icp.py); over a short replay the map absorbs the
# differences, so the same bound holds with 1 mm of slack
POS_MM, ANG_RAD = 2.0, 2e-3


def _configs(**kw):
    """The slice config (offline, no GICP rescue) cut to a 12 m x 12 m map
    and a 2048-point buffer, for both packages."""
    def make(m, backend):
        return m.OFFLINE_CONFIG.replace(
            map=m.MapConfig(width_mm=12000.0, height_mm=12000.0),
            map_capacity=2048, local_map_capacity=2048,
            icp=dataclasses.replace(m.OFFLINE_CONFIG.icp, rescue_estimator="", backend=backend),
            occupancy=dataclasses.replace(m.OFFLINE_CONFIG.occupancy, backend=backend),
        ).replace(**kw)
    return make(jc, "fused"), make(tc, "auto")


def _scans(n, seed=7):
    scans, gt = chip_smoke.synthetic_sequence(n, seed=seed)
    padded = np.zeros((n, 512, 3), np.float32)
    padded[:, : scans.shape[1]] = scans
    return padded, gt


def _compare(jstate, jouts, tstate, touts, map_slack=0.01):
    acc = np.asarray(jouts.accepted)
    np.testing.assert_array_equal(touts.accepted.numpy(), acc)
    dp = np.abs(touts.pose.numpy() - np.asarray(jouts.pose))
    assert dp[:, :2].max() <= POS_MM, dp
    assert dp[:, 2].max() <= ANG_RAD, dp
    jm, tm = int(np.asarray(jstate.map_valid).sum()), int(tstate.map_valid.sum())
    assert abs(jm - tm) <= map_slack * jm + 5, (jm, tm)
    docc = np.abs(tstate.occ.numpy() - np.asarray(jstate.occ))
    assert (docc <= 1e-5).mean() >= 0.995, (docc > 1e-5).mean()


def test_replay_matches_jax():
    jcfg, tcfg = _configs()
    padded, gt = _scans(14)
    jstate, jouts = jpipe.run_sequence(jnp.asarray(padded), jcfg)
    tstate, touts = port.run_sequence(padded, tcfg, device="cpu")
    _compare(jstate, jouts, tstate, touts)
    assert touts.accepted.numpy().all()
    rel = chip_smoke.relative_poses(gt)[1:]
    assert np.hypot(*(touts.pose.numpy()[:, :2] - rel[:, :2]).T).max() < 200.0


def test_options_match_jax():
    """motion_model, the duplicate filter and a compacted ICP target buffer
    together; then localization-only against the frozen seed map."""
    padded, _ = _scans(6, seed=3)
    jcfg, tcfg = _configs(motion_model=True, use_duplicate_filter=True, local_map_capacity=1024)
    _compare(*jpipe.run_sequence(jnp.asarray(padded), jcfg), *port.run_sequence(padded, tcfg, device="cpu"))
    jcfg, tcfg = _configs(localization_only=True)
    js, jo = jpipe.run_sequence(jnp.asarray(padded), jcfg)
    ts, to = port.run_sequence(padded, tcfg, device="cpu")
    _compare(js, jo, ts, to)
    np.testing.assert_array_equal(ts.map_valid.numpy(), np.asarray(js.map_valid))


def _step_both(jstate, tstate, scan, jcfg, tcfg):
    js, jo = jpipe.make_step(jcfg)(jstate, jnp.asarray(scan))
    ts, to = tpipe.make_step(tcfg)(tstate, torch.from_numpy(scan))
    assert bool(to.accepted) == bool(jo.accepted)
    np.testing.assert_allclose(to.pose.numpy()[:2], np.asarray(jo.pose)[:2], atol=1.0)
    assert abs(float(to.pose[2]) - float(jo.pose[2])) <= 2e-3
    assert abs(int(ts.map_valid.sum()) - int(np.asarray(js.map_valid).sum())) <= 5
    assert int(ts.step) == int(js.step)


def test_state_carried_across(tmp_path):
    """JAX Slam.save_state -> port Slam.load_state, one step on each side;
    and the port's state back into the JAX pipeline."""
    jcfg, tcfg = _configs()
    padded, _ = _scans(6, seed=21)
    js = japi.Slam(jcfg)
    for scan in padded[:5]:
        js.add_scan(scan)
    path = str(tmp_path / "state.npz")
    js.save_state(path)
    ts = port.Slam(tcfg, device="cpu")
    ts.load_state(path)
    for k, v in state_to_numpy(ts.state).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js.state, k)), err_msg=k)
    _step_both(js.state, ts.state, padded[5], jcfg, tcfg)

    # the other direction: the port's arrays are a JAX SlamState
    back = jpipe.SlamState(**{k: jnp.asarray(v) for k, v in state_to_numpy(ts.state).items()})
    _step_both(back, state_from_numpy(state_to_numpy(ts.state), "cpu"), padded[5], jcfg, tcfg)


def test_rejected_scan_leaves_state_unchanged():
    _, tcfg = _configs()
    padded, _ = _scans(2)
    state = tpipe.init_state(torch.from_numpy(padded[0]), tcfg)
    moved = state._replace(pose=torch.tensor([30.0, -20.0, 0.01]))
    new, out = tpipe.make_step(tcfg)(moved, torch.zeros((512, 3)))
    assert not bool(out.accepted)
    for name in ("pose", "map_xy", "map_valid", "occ", "prev_xy", "prev_valid", "maint_count", "reject_run"):
        assert torch.equal(getattr(new, name), getattr(moved, name)), name
    assert int(new.step) == int(moved.step) + 1
    assert torch.equal(new.prev_pose, moved.pose)


def test_streaming_equals_batch():
    _, tcfg = _configs()
    padded, _ = _scans(5, seed=2)
    s = port.Slam(tcfg, device="cpu")
    for scan in padded:
        s.add_scan(scan[:360])
    _, outs = port.Slam(tcfg, device="cpu").run(padded)
    np.testing.assert_allclose(np.asarray(s.trajectory)[1:], outs.pose.numpy(), atol=1e-4)
    assert s.map_points().shape[1] == 2 and s.occupancy().shape == (400, 400)


def _garbage(scans, seed=0):
    """The same beams with ranges drawn at random: a scan no pose explains."""
    rng = np.random.default_rng(seed)
    out = scans.copy()
    out[..., 2] = np.where(out[..., 2] > 0, rng.uniform(1200.0, 8000.0, out[..., 2].shape), 0.0)
    return out.astype(np.float32)


@pytest.mark.parametrize("change", [
    dict(icp_rescue="gicp"), dict(realtime_semantics=True), dict(use_outlier_filter=True),
    dict(reseed_after_rejects=2),
])
def test_ported_features_match_jax(change):
    """The four features that raised before they were ported, each switched
    on alone on the cut offline configuration: a 7-scan replay with two
    garbage scans in the middle (they are rejected: the rescue runs on them,
    and the second one triggers the reseed) matches the JAX replay."""
    kw = dict(change)
    jcfg, tcfg = _configs()
    if "icp_rescue" in kw:
        est = kw.pop("icp_rescue")
        kw = {}
        jcfg = jcfg.replace(icp=dataclasses.replace(jcfg.icp, rescue_estimator=est, gicp_epsilon=0.1))
        tcfg = tcfg.replace(icp=dataclasses.replace(tcfg.icp, rescue_estimator=est, gicp_epsilon=0.1))
    jcfg, tcfg = jcfg.replace(**kw), tcfg.replace(**kw)
    padded, _ = _scans(7, seed=5)
    padded[3:5] = _garbage(padded[3:5])
    jstate, jouts = jpipe.run_sequence(jnp.asarray(padded), jcfg)
    tstate, touts = port.run_sequence(padded, tcfg, device="cpu")
    _compare(jstate, jouts, tstate, touts)
    np.testing.assert_array_equal(touts.accepted.numpy()[:4], [True, True, False, False])
    np.testing.assert_allclose(touts.rmse.numpy(), np.asarray(jouts.rmse), atol=1.0)
    assert int(tstate.reject_run) == int(jstate.reject_run)
    assert int(tstate.maint_count) == int(jstate.maint_count)


def test_device_rule():
    """No device means the card: without CUDA that raises; "cpu" must be
    asked for."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.Slam(tc.SlamConfig())
    with pytest.raises(RuntimeError):
        port.run_sequence(np.zeros((2, 512, 3), np.float32), tc.SlamConfig())
    assert port.Slam(tc.SlamConfig(), device="cpu").device.type == "cpu"


def test_package_imports_no_jax():
    """The package and the modules that copy the JAX package's jax-free ones
    (``data/``, ``acquisition/``, ``native/``) or stand in for PIL
    (``utils/images``, the labeler app, the CLI), the shared-map fleet and
    the profiling helpers import neither JAX, nor the JAX package, nor PIL,
    nor OpenCV (the card's machine has none of them; the live camera imports
    OpenCV only when it opens)."""
    modules = ["icp_slam_yolo_tpu_torch", "icp_slam_yolo_tpu_torch.utils.images", "icp_slam_yolo_tpu_torch.data.csvutil",
               "icp_slam_yolo_tpu_torch.data.settings", "icp_slam_yolo_tpu_torch.data.labels",
               "icp_slam_yolo_tpu_torch.data.split", "icp_slam_yolo_tpu_torch.data.labeler",
               "icp_slam_yolo_tpu_torch.serve.labeler_app", "icp_slam_yolo_tpu_torch.cli",
               "icp_slam_yolo_tpu_torch.parallel.shared", "icp_slam_yolo_tpu_torch.acquisition",
               "icp_slam_yolo_tpu_torch.acquisition.lidar", "icp_slam_yolo_tpu_torch.acquisition.camera",
               "icp_slam_yolo_tpu_torch.native", "icp_slam_yolo_tpu_torch.native.robotlink",
               "icp_slam_yolo_tpu_torch.native.scanloader", "icp_slam_yolo_tpu_torch.utils.profiling"]
    code = ("import sys, importlib; [importlib.import_module(m) for m in sys.argv[1:]]; "
            "bad = [m for m in sys.modules if m in ('jax', 'icp_slam_yolo_tpu', 'PIL', 'cv2')"
            " or m.startswith(('jax.', 'icp_slam_yolo_tpu.', 'PIL.', 'cv2.'))]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code, *modules], cwd=REPO, env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    pkg = os.path.join(REPO, "icp_slam_yolo_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cu")):
                src = open(os.path.join(root, f)).read()
                assert "icp_slam_yolo_tpu." not in src.replace("icp_slam_yolo_tpu_torch", ""), f
                assert "import jax" not in src and "from jax" not in src, f


def test_tf32_stays_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
