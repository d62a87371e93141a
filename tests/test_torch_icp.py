"""K1 (the fused ICP loop) and the registration API: the port's plain
version vs the JAX Pallas kernel in interpret mode and the JAX API.

Tolerances: pose <= 1 mm / 2e-3 rad and rmse <= 1 mm, as the JAX package
holds its own fused kernel to its XLA path (`tests/test_icp_fused.py`).
The nearest neighbour is chosen in difference form here and in Gram form in
the JAX kernel, and the moments sum in another order, so the two agree to
rounding, not bits.  Iteration counts are compared at tolerance 1e-2 (a
real convergence decision) within 3 iterations; at the default 1e-5 the
stopping step is decided by the last bit of the mean error."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from icp_slam_yolo_tpu.config import OFFLINE_GATE, IcpConfig as JIcpConfig
from icp_slam_yolo_tpu.core import registration as jreg
from icp_slam_yolo_tpu.ops import geometry as jgeo
from icp_slam_yolo_tpu.ops import voxel as jvoxel
from icp_slam_yolo_tpu.ops.pallas.icp_fused import icp_fused_pallas
from icp_slam_yolo_tpu_torch.config import IcpConfig
from icp_slam_yolo_tpu_torch.core import registration as treg
from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import _plain_loop, _prepare, icp_fused, icp_fused_plain

torch.set_num_threads(2)


def _pad(p, n):
    xy = np.zeros((n, 2), np.float32)
    xy[: len(p)] = p[:n]
    v = np.zeros(n, bool)
    v[: min(len(p), n)] = True
    return xy, v


def _room_pair(seed=5, t_slots=1024):
    """Two consecutive synthetic warehouse scans: downsampled source (512
    slots) and target (``t_slots`` slots), both gated like the pipeline."""
    scans, _ = chip_smoke.synthetic_sequence(2, seed=seed)
    pad = np.zeros((2, 512, 3), np.float32)
    pad[:, : scans.shape[1]] = scans
    a, av = jgeo.polar_to_cartesian(jnp.asarray(pad[0]), OFFLINE_GATE)
    b, bv = jgeo.polar_to_cartesian(jnp.asarray(pad[1]), OFFLINE_GATE)
    s, sv = jvoxel.voxel_downsample(b, bv, 20.0)
    t, tv = jvoxel.compact(a, av, t_slots)
    return [np.asarray(x) for x in (s, sv, t, tv)]


def _both(src, sv, tgt, tv, init, **kw):
    j = icp_fused_pallas(*(jnp.asarray(x) for x in (src, sv, tgt, tv, init)), interpret=True, **kw)
    t = icp_fused(*(torch.from_numpy(np.array(x))[None] for x in (src, sv, tgt, tv, init)), **kw)  # B = 1
    return [np.asarray(x) for x in j], [x[0].numpy() for x in t]


def _close(j, t, iters_slack=None):
    jp, jr, jn, ji = j
    tp, tr, tn, ti = t
    assert np.abs(tp[:2] - jp[:2]).max() <= 1.0, (tp, jp)
    assert abs(tp[2] - jp[2]) <= 2e-3
    if np.isfinite(jr):
        assert abs(float(tr) - float(jr)) <= 1.0
    else:
        assert not np.isfinite(tr)
    assert abs(int(tn) - int(jn)) <= 2
    if iters_slack is not None:
        assert abs(int(ti) - int(ji)) <= iters_slack, (ti, ji)


@pytest.mark.parametrize("tol", [1e-5, 1e-2])
def test_room_pair_matches_pallas_interpret(tol):
    src, sv, tgt, tv = _room_pair()
    init = np.array([30.0, -20.0, 0.01], np.float32)
    j, t = _both(src, sv, tgt, tv, init, iters=50, threshold_mm=200.0, tolerance=tol)
    _close(j, t, iters_slack=3 if tol >= 1e-2 else None)
    assert int(t[2]) > 100


def test_known_transform(rng):
    theta = np.radians(8.0)
    shift = np.array([120.0, -60.0])
    tgt = rng.normal(size=(256, 2)) * 3000.0
    c, s = np.cos(theta), np.sin(theta)
    src = (tgt - shift) @ np.array([[c, -s], [s, c]])
    sxy, sv = _pad(src, 256)
    txy, tv = _pad(tgt, 256)
    init = np.zeros(3, np.float32)
    j, t = _both(sxy, sv, txy, tv, init, iters=50, threshold_mm=500.0, tolerance=1e-2)
    _close(j, t, iters_slack=3)
    assert abs(float(t[0][2]) - theta) < 2e-3
    np.testing.assert_allclose(t[0][:2], shift, atol=10.0)
    assert float(t[1]) < 10.0


def test_no_inliers():
    sxy, sv = _pad(np.zeros((32, 2)) + 1e5, 128)
    txy, tv = _pad(np.zeros((32, 2)) - 1e5, 128)
    j, t = _both(sxy, sv, txy, tv, np.zeros(3, np.float32), iters=5, threshold_mm=10.0, tolerance=1e-5)
    _close(j, t, iters_slack=0)
    assert not np.isfinite(t[1]) and int(t[2]) == 0


@pytest.mark.parametrize("anderson", [False, True])
def test_cpu_packed_early_exit_equals_full_sweep(anderson):
    """On the CPU the plain version packs the valid targets first and stops
    once every registration has converged; the card's plain version sweeps
    every slot for all iterations.  Both give the same bits, here on a
    sparse map (the room's targets scattered over 4096 slots, each problem
    with its own holes) with three registrations that converge at different
    iterations."""
    src, sv, tgt, tv = _room_pair(t_slots=1024)
    rng = np.random.default_rng(4)
    b, slots = 3, 4096
    n = int(tv.sum())
    txy, tval = np.zeros((b, slots, 2), np.float32), np.zeros((b, slots), bool)
    for r in range(b):
        at = np.sort(rng.choice(slots, n, replace=False))
        txy[r, at], tval[r, at] = tgt[:n], True
        txy[r, ~tval[r]] = rng.normal(0.0, 3000.0, (slots - n, 2))  # junk under the mask
    init = np.array([[30.0, -20.0, 0.01], [-80.0, 55.0, -0.03], [5.0, 5.0, 0.0]], np.float32)
    s_t, sv_t = (torch.from_numpy(np.repeat(x[None], b, 0)) for x in (src, sv))
    t_t, tv_t = torch.from_numpy(txy), torch.from_numpy(tval)
    params, tgt_c, _ = _prepare(t_t, tv_t, torch.from_numpy(init))
    kw = dict(iters=50, thr2=200.0 ** 2, tolerance=1e-5, anderson=anderson)
    packed = icp_fused_plain(s_t, sv_t, tgt_c, tv_t, params, **kw)
    full = _plain_loop(s_t, sv_t, tgt_c, tv_t, params, stop_when_done=False, **kw)
    iters = packed[:, 6]
    assert len(set(iters.tolist())) > 1 and float(iters.max()) < 50  # staggered, and the loop stopped early
    assert torch.equal(packed, full)


def test_anderson_matches_pallas_interpret():
    src, sv, tgt, tv = _room_pair(seed=9, t_slots=512)
    init = np.array([60.0, 40.0, -0.02], np.float32)
    j, t = _both(src, sv, tgt, tv, init, iters=50, threshold_mm=200.0, tolerance=1e-2, anderson=True)
    _close(j, t, iters_slack=3)


@pytest.mark.parametrize("backend", ["auto", "fused"])
def test_icp_masked_matches_jax(backend):
    """The port's ``auto`` and ``fused`` (both K1, its plain version on the
    CPU) vs JAX ``fused``."""
    src, sv, tgt, tv = _room_pair(seed=11)
    init = np.array([-40.0, 25.0, 0.015], np.float32)
    jcfg = JIcpConfig(backend="fused", tolerance=1e-2)
    tcfg = IcpConfig(backend=backend, tolerance=1e-2)
    jr = jreg.icp_masked(*(jnp.asarray(x) for x in (src, sv, tgt, tv, init)), jcfg)
    tr = treg.icp_masked(*(torch.from_numpy(x)[None] for x in (src, sv, tgt, tv, init)), tcfg)
    tr = type(tr)(*(x[0] for x in tr))
    np.testing.assert_allclose(tr.pose.numpy()[:2], np.asarray(jr.pose)[:2], atol=1.0)
    assert abs(float(tr.pose[2]) - float(jr.pose[2])) <= 2e-3
    assert abs(float(tr.rmse) - float(jr.rmse)) <= 1.0
    assert abs(float(tr.fitness) - float(jr.fitness)) <= 0.01
    assert abs(int(tr.n_iters) - int(jr.n_iters)) <= 3


def test_degenerate_rule():
    """Fewer than min_points valid source points -> +inf rmse, init pose."""
    src, sv, tgt, tv = _room_pair()
    sv = sv.copy()
    sv[np.flatnonzero(sv)[5:]] = False
    init = np.array([10.0, 20.0, 0.3], np.float32)
    r = treg.icp_masked(*(torch.from_numpy(x)[None] for x in (src, sv, tgt, tv, init)), IcpConfig())
    assert not np.isfinite(float(r.rmse))
    np.testing.assert_array_equal(r.pose[0].numpy(), init)


def test_register_api_matches_jax():
    scans, _ = chip_smoke.synthetic_sequence(2, seed=13)
    from icp_slam_yolo_tpu.reference_impl import oracle

    a = oracle.polar_gate(scans[0].astype(np.float64), OFFLINE_GATE)
    b = oracle.voxel_downsample(oracle.polar_gate(scans[1].astype(np.float64), OFFLINE_GATE), 20.0)
    cfg = dataclasses.replace(JIcpConfig(), tolerance=1e-2)
    jr_, jt_, jrm = jreg.register(b, a, cfg=cfg)
    tr_, tt_, trm = treg.register(b, a, cfg=IcpConfig(tolerance=1e-2), device="cpu")
    np.testing.assert_allclose(tr_, jr_, atol=2e-3)
    np.testing.assert_allclose(tt_, jt_, atol=1.0)
    assert abs(trm - jrm) <= 1.0


def test_register_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        treg.register(np.zeros((20, 2)), np.zeros((20, 2)))
