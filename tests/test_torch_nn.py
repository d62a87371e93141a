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


def _b(a):
    """One problem as the port takes it: a tensor with a leading axis of 1."""
    return _t(a)[None]


@pytest.mark.parametrize("s,t", [(64, 128), (512, 512), (256, 1024)])
def test_nn_argmin_matches_pallas_interpret(s, t):
    """Indices exact; d2 to float32 rounding of the same difference form."""
    rng = np.random.default_rng(s + t)
    src = rng.uniform(-5000, 5000, (s, 2)).astype(np.float32)
    tgt = rng.uniform(-5000, 5000, (t, 2)).astype(np.float32)
    valid = rng.random(t) < 0.8
    jd, ji = nn_argmin_pallas(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid), interpret=True)
    td, ti = nn_argmin(_b(src), _b(tgt), _b(valid))
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd), rtol=1e-6)


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
    td, ti = nn_argmin(_b(src), _b(tgt), _b(valid))
    ti = ti[0].numpy()
    np.testing.assert_array_equal(ti, np.asarray(ji))
    assert (ti[16:] < 64).all(), "ties must resolve to the first index"
    assert (ti[:16] >= 64).all() and valid[ti].all(), "masked targets must never match"


def test_no_valid_target():
    src = _b(np.zeros((8, 2), np.float32))
    tgt = _b(np.ones((128, 2), np.float32))
    d, i = nn_argmin(src, tgt, torch.zeros((1, 128), dtype=torch.bool))
    jd, ji = nn_argmin_pallas(jnp.zeros((8, 2)), jnp.ones((128, 2)), jnp.zeros(128, bool), interpret=True)
    np.testing.assert_array_equal(d[0].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(i[0].numpy(), np.asarray(ji))


def test_wrapper_cpu_runs_plain_and_checks_inputs():
    src = torch.zeros((1, 8, 2))
    tgt = torch.ones((1, 16, 2))
    valid = torch.ones((1, 16), dtype=torch.bool)
    before = pallas.LAUNCHES["nn_argmin"]
    d, i = nn_argmin(src, tgt, valid)
    dp, ip = nn_argmin_plain(src, tgt, valid)
    assert torch.equal(d, dp) and torch.equal(i, ip)
    assert pallas.LAUNCHES["nn_argmin"] == before, "a CPU call launches no kernel"
    with pytest.raises(TypeError):
        nn_argmin(src.double(), tgt, valid)
    with pytest.raises(ValueError):
        nn_argmin(src, tgt, valid[:, :8])
    with pytest.raises(ValueError, match="contiguous"):
        nn_argmin(torch.zeros((1, 2, 8)).transpose(1, 2), tgt, valid)
    with pytest.raises(ValueError, match="src_xy"):  # one problem still carries the leading axis
        nn_argmin(src[0], tgt[0], valid[0])


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
    td, ti = nearest_neighbor(_b(src), _b(tgt), _b(valid), _b(svalid))
    np.testing.assert_allclose(td[0].numpy() ** 2, np.asarray(jd) ** 2, atol=20.0, rtol=0)
    np.testing.assert_array_equal(ti[0].numpy()[svalid], np.asarray(ji)[svalid])


@pytest.mark.parametrize("seed", [0, 1])
def test_dynamic_points_mask(seed):
    rng = np.random.default_rng(seed)
    prev = rng.uniform(-5000, 5000, (512, 2)).astype(np.float32)
    cur = (prev + rng.normal(0, 150, prev.shape)).astype(np.float32)
    cur[:40] += 20000.0  # moved objects, far from every previous point
    cv, pv = rng.random(512) < 0.9, rng.random(512) < 0.9
    j = joutliers.dynamic_points_mask(jnp.asarray(cur), jnp.asarray(cv), jnp.asarray(prev),
                                      jnp.asarray(pv), 250.0)
    t = toutliers.dynamic_points_mask(_b(cur), _b(cv), _b(prev), _b(pv), 250.0)[0]
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert not t.numpy()[:40].any()
    # an empty previous scan keeps every valid point
    empty = toutliers.dynamic_points_mask(_b(cur), _b(cv), _b(prev), torch.zeros((1, 512), dtype=torch.bool), 250.0)
    np.testing.assert_array_equal(empty[0].numpy(), cv)
