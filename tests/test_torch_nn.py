"""K3 (nearest-neighbour argmin) and the dynamic-point filter: the port's
plain version vs the JAX Pallas kernel in interpret mode and the JAX ops."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_slam_yolo_tpu.ops import outliers as joutliers
from icp_slam_yolo_tpu.ops.pallas.nn_kernel import nn_argmin_pallas
from icp_slam_yolo_tpu_torch.ops import outliers as toutliers
from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.nn import nearest_neighbor
from icp_slam_yolo_tpu_torch.ops.pallas.nn_kernel import nn_argmin, nn_argmin_plain

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("s,t", [(64, 128), (512, 512), (256, 1024)])
def test_nn_argmin_matches_pallas_interpret(s, t):
    """Indices exact; d2 to float32 rounding of the same difference form."""
    rng = np.random.default_rng(s + t)
    src = rng.uniform(-5000, 5000, (s, 2)).astype(np.float32)
    tgt = rng.uniform(-5000, 5000, (t, 2)).astype(np.float32)
    valid = rng.random(t) < 0.8
    jd, ji = nn_argmin_pallas(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid), interpret=True)
    td, ti = nn_argmin(_t(src), _t(tgt), _t(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)


def test_ties_go_to_first_index_and_mask_excludes():
    """Duplicated targets tie exactly: both sides pick the first copy; a
    masked-out copy is never picked."""
    rng = np.random.default_rng(3)
    base = rng.uniform(-3000, 3000, (64, 2)).astype(np.float32)
    tgt = np.concatenate([base, base])          # copy j + 64 ties with j
    src = (base + rng.normal(0, 20, base.shape)).astype(np.float32)
    valid = np.ones(128, bool)
    valid[:16] = False                         # first copies of 0..15 masked
    jd, ji = nn_argmin_pallas(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid), interpret=True)
    td, ti = nn_argmin(_t(src), _t(tgt), _t(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    ti = ti.numpy()
    assert (ti[16:] < 64).all(), "ties must resolve to the first index"
    assert (ti[:16] >= 64).all() and valid[ti].all(), "masked targets must never match"


def test_no_valid_target():
    src = _t(np.zeros((8, 2), np.float32))
    tgt = _t(np.ones((128, 2), np.float32))
    d, i = nn_argmin(src, tgt, torch.zeros(128, dtype=torch.bool))
    jd, ji = nn_argmin_pallas(jnp.zeros((8, 2)), jnp.ones((128, 2)), jnp.zeros(128, bool), interpret=True)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_wrapper_cpu_runs_plain_and_checks_inputs():
    src = torch.zeros((8, 2))
    tgt = torch.ones((16, 2))
    valid = torch.ones(16, dtype=torch.bool)
    before = pallas.LAUNCHES["nn_argmin"]
    d, i = nn_argmin(src, tgt, valid)
    dp, ip = nn_argmin_plain(src, tgt, valid)
    assert torch.equal(d, dp) and torch.equal(i, ip)
    assert pallas.LAUNCHES["nn_argmin"] == before, "a CPU call launches no kernel"
    with pytest.raises(TypeError):
        nn_argmin(src.double(), tgt, valid)
    with pytest.raises(ValueError):
        nn_argmin(src, tgt, valid[:8])
    with pytest.raises(ValueError):
        nn_argmin(torch.zeros((2, 8)).t(), tgt, valid)


def test_nearest_neighbor_distances(rng):
    """Against the JAX op's CPU path (centred matmul form): squared distances
    to 20 mm² (that path's d² in m² cancels against |p|² ~ 25 m² in f32,
    ~1e-5 m² of error), same indices."""
    from icp_slam_yolo_tpu.ops.nn import nearest_neighbor as jnn

    src = rng.uniform(-5000, 5000, (256, 2)).astype(np.float32)
    tgt = rng.uniform(-5000, 5000, (512, 2)).astype(np.float32)
    valid = rng.random(512) < 0.7
    svalid = rng.random(256) < 0.9
    jd, ji = jnn(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid), jnp.asarray(svalid))
    td, ti = nearest_neighbor(_t(src), _t(tgt), _t(valid), _t(svalid))
    np.testing.assert_allclose(td.numpy() ** 2, np.asarray(jd) ** 2, atol=20.0, rtol=0)
    np.testing.assert_array_equal(ti.numpy()[svalid], np.asarray(ji)[svalid])


@pytest.mark.parametrize("seed", [0, 1])
def test_dynamic_points_mask(seed):
    rng = np.random.default_rng(seed)
    prev = rng.uniform(-5000, 5000, (512, 2)).astype(np.float32)
    cur = (prev + rng.normal(0, 150, prev.shape)).astype(np.float32)
    cur[:40] += 20000.0  # moved objects, far from every previous point
    cv, pv = rng.random(512) < 0.9, rng.random(512) < 0.9
    j = joutliers.dynamic_points_mask(jnp.asarray(cur), jnp.asarray(cv), jnp.asarray(prev),
                                      jnp.asarray(pv), 250.0)
    t = toutliers.dynamic_points_mask(_t(cur), _t(cv), _t(prev), _t(pv), 250.0)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert not t.numpy()[:40].any()
    # an empty previous scan keeps every valid point
    empty = toutliers.dynamic_points_mask(_t(cur), _t(cv), _t(prev), torch.zeros(512, dtype=torch.bool), 250.0)
    np.testing.assert_array_equal(empty.numpy(), cv)
