"""The general ICP loop (``gicp``, ``point_to_plane``, Huber weights,
Anderson) and the ``gicp()`` host API: the port vs the JAX package's XLA loop
(``backend="xla"``), on seeded synthetic warehouse scans, on the CPU.

Tolerance: pose <= 1 mm / 2e-3 rad, rmse <= 1 mm, as for K1.  The port's
nearest neighbour is K3's difference form and the JAX loop's (off a TPU) the
Gram form in metres, so the mean error differs in its last digits: at the
default ``tolerance=1e-5`` the two freeze at different iterations (the
iteration counts are not compared there), which moves the pose only where
the objective is nearly flat.  The cases below are conditioned well enough to
agree within the tolerance; plain ``gicp`` at Segal's ``epsilon=1e-3`` slides
along the walls between iterations 20 and 50 by millimetres and is compared
with Anderson on, which reaches the fixed point on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import icp_slam_yolo_tpu_torch as port
from icp_slam_yolo_tpu.config import OFFLINE_GATE, IcpConfig as JIcpConfig
from icp_slam_yolo_tpu.core import registration as jreg
from icp_slam_yolo_tpu.reference_impl import oracle
from icp_slam_yolo_tpu_torch.config import IcpConfig
from icp_slam_yolo_tpu_torch.core import registration as treg
from test_torch_icp import _room_pair

torch.set_num_threads(2)

CASES = {
    "gicp_eps0.1": dict(estimator="gicp", gicp_epsilon=0.1),          # the presets' rescue
    "gicp_anderson": dict(estimator="gicp", anderson=True),
    "point_to_plane": dict(estimator="point_to_plane"),
    "huber": dict(huber_delta_mm=50.0),
    "huber_anderson": dict(huber_delta_mm=30.0, anderson=True),
    "gicp_k8": dict(estimator="gicp", gicp_epsilon=0.1, gicp_k=8, max_iterations=30),
}


def _args(mod, arrays):
    """One registration's arrays for JAX, or for the port with its leading
    axis of 1."""
    if mod is jnp:
        return [jnp.asarray(x) for x in arrays]
    return [torch.from_numpy(np.array(x))[None] for x in arrays]


def _one(res):
    return type(res)(*(x[0] for x in res))


def _assert_close(tr, jr):
    np.testing.assert_allclose(np.asarray(tr.pose)[..., :2], np.asarray(jr.pose)[..., :2], atol=1.0)
    np.testing.assert_allclose(np.asarray(tr.pose)[..., 2], np.asarray(jr.pose)[..., 2], atol=2e-3)
    np.testing.assert_allclose(np.asarray(tr.rmse), np.asarray(jr.rmse), atol=1.0)
    assert np.abs(np.asarray(tr.n_inliers) - np.asarray(jr.n_inliers)).max() <= 2
    np.testing.assert_allclose(np.asarray(tr.fitness), np.asarray(jr.fitness), atol=0.01)


@pytest.mark.parametrize("case", sorted(CASES))
def test_estimators_match_jax_xla(case):
    """Each estimator option that raised before the general loop was ported
    now runs and matches the JAX loop."""
    arrays = (*_room_pair(seed=11), np.array([-40.0, 25.0, 0.015], np.float32))
    jr = jreg.icp_masked(*_args(jnp, arrays), JIcpConfig(backend="xla", **CASES[case]))
    tr = _one(treg.icp_masked(*_args(torch, arrays), IcpConfig(backend="xla", **CASES[case])))
    _assert_close(tr, jr)
    assert np.isfinite(float(tr.rmse)) and int(tr.n_inliers) > 100
    assert 0 < int(tr.n_iters) <= CASES[case].get("max_iterations", 50)


def test_iterations_at_a_real_convergence_decision():
    arrays = (*_room_pair(seed=5), np.array([30.0, -20.0, 0.01], np.float32))
    kw = dict(estimator="point_to_plane", tolerance=0.05)
    jr = jreg.icp_masked(*_args(jnp, arrays), JIcpConfig(backend="xla", **kw))
    tr = _one(treg.icp_masked(*_args(torch, arrays), IcpConfig(**kw)))
    assert abs(int(tr.n_iters) - int(jr.n_iters)) <= 3 and int(tr.n_iters) < 50
    np.testing.assert_allclose(tr.pose.numpy()[:2], np.asarray(jr.pose)[:2], atol=2.0)


def test_general_loop_batched_equals_rows():
    """Three registrations in one call against one call each."""
    pairs = [(*_room_pair(seed=s), np.array(init, np.float32))
             for s, init in ((11, [-40.0, 25.0, 0.015]), (5, [30.0, -20.0, 0.01]), (9, [60.0, 40.0, -0.02]))]
    cfg = IcpConfig(estimator="gicp", gicp_epsilon=0.1, max_iterations=15)
    stacked = [torch.from_numpy(np.stack([p[i] for p in pairs])) for i in range(5)]
    whole = treg.icp_masked(*stacked, cfg)
    assert whole.pose.shape == (3, 3) and whole.n_iters.shape == (3,)
    for b, p in enumerate(pairs):
        one = _one(treg.icp_masked(*_args(torch, p), cfg))
        np.testing.assert_allclose(whole.pose[b].numpy(), one.pose.numpy(), atol=1e-2)
        assert abs(float(whole.rmse[b]) - float(one.rmse)) <= 1e-2
        assert int(whole.n_iters[b]) == int(one.n_iters)


def test_degenerate_rule_general_loop():
    src, sv, tgt, tv = _room_pair()
    sv = sv.copy()
    sv[np.flatnonzero(sv)[5:]] = False
    init = np.array([10.0, 20.0, 0.3], np.float32)
    r = _one(treg.icp_masked(*_args(torch, (src, sv, tgt, tv, init)), IcpConfig(estimator="gicp", max_iterations=3)))
    assert not np.isfinite(float(r.rmse))
    np.testing.assert_array_equal(r.pose.numpy(), init)


def test_backend_rules():
    z = torch.zeros((1, 8, 2))
    v = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="one such ICP"):
        treg.icp_masked(z, v, z, v, torch.zeros((1, 3)), IcpConfig(backend="xla"))
    with pytest.raises(ValueError, match="fused"):
        treg.icp_masked(z, v, z, v, torch.zeros((1, 3)), IcpConfig(estimator="gicp", backend="fused"))
    with pytest.raises(ValueError, match="estimator"):
        treg.icp_masked(z, v, z, v, torch.zeros((1, 3)), IcpConfig(estimator="svd"))
    with pytest.raises(ValueError, match="backend"):
        treg.icp_masked(z, v, z, v, torch.zeros((1, 3)), IcpConfig(backend="mxu"))


def _gated_pair(seed):
    scans, _ = chip_smoke.synthetic_sequence(2, seed=seed)
    a = oracle.polar_gate(scans[0].astype(np.float64), OFFLINE_GATE)
    b = oracle.polar_gate(scans[1].astype(np.float64), OFFLINE_GATE)
    return b, a


@pytest.mark.parametrize("init", ["none", "se2", "mat44"])
def test_gicp_api_matches_jax(init):
    p1, p2 = _gated_pair(13)
    trans = {"none": None, "se2": np.array([100.0, 10.0, 0.01], np.float32),
             "mat44": np.array([[1, 0, 0, 120.0], [0, 1, 0, -5.0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)}[init]
    jr, jt = jreg.gicp(p1, p2, threshold=200.0, voxel_size=20.0, trans_init=trans)
    tr, tt = port.gicp(p1, p2, threshold=200.0, voxel_size=20.0, trans_init=trans, device="cpu")
    assert tt.shape == (4, 4) and tt.dtype == np.float64
    assert abs(tr - jr) <= 1.0 and np.isfinite(tr)
    np.testing.assert_allclose(tt[:2, 3], jt[:2, 3], atol=1.0)
    np.testing.assert_allclose(tt[:2, :2], jt[:2, :2], atol=2e-3)
    np.testing.assert_array_equal(tt[2:], np.eye(4)[2:])


def test_gicp_api_too_few_points():
    p1, p2 = _gated_pair(13)
    for a, b in ((p1[:9], p2), (p1, p2[:3])):
        rmse, t = port.gicp(a, b, device="cpu")
        assert rmse == float("inf")
        np.testing.assert_array_equal(t, np.eye(4))
    # decided before any device is asked for
    assert port.gicp(p1[:2], p2)[0] == float("inf")


def test_gicp_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p1, p2 = _gated_pair(13)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.gicp(p1, p2)
