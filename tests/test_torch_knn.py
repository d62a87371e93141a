"""k-NN, local covariances, the statistical outlier filter and the batched
voxel ops: the port vs the JAX package on seeded numpy inputs, on the CPU
(where the JAX side takes its exact ``top_k``, the path the port mirrors).

Tolerances: neighbour index sets equal on tie-free data; covariances 1e-4
(entries are O(1)); mean k-NN distance 1e-2 mm; outlier masks equal except
for points within 0.05 mm of the threshold; voxel means 1e-3 mm (prefix sums
add in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from icp_slam_yolo_tpu.config import OFFLINE_GATE
from icp_slam_yolo_tpu.ops import geometry as jgeo
from icp_slam_yolo_tpu.ops import nn as jnn
from icp_slam_yolo_tpu.ops import outliers as jout
from icp_slam_yolo_tpu.ops import voxel as jvoxel
from icp_slam_yolo_tpu_torch.ops import nn as tnn
from icp_slam_yolo_tpu_torch.ops import outliers as tout
from icp_slam_yolo_tpu_torch.ops import voxel as tvoxel

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scan_cloud(seed, n_max=512):
    """A gated synthetic warehouse scan: ``(xy (n_max, 2), valid (n_max,))``."""
    scans, _ = chip_smoke.synthetic_sequence(1, seed=seed)
    pad = np.zeros((n_max, 3), np.float32)
    pad[: scans.shape[1]] = scans[0]
    xy, valid = jgeo.polar_to_cartesian(jnp.asarray(pad), OFFLINE_GATE)
    return np.array(xy), np.array(valid)


def _random_cloud(rng, n, frac=0.85):
    return rng.uniform(-4000, 4000, (n, 2)).astype(np.float32), rng.random(n) < frac


def test_pairwise_sqdist(rng):
    a = rng.uniform(-5, 5, (40, 2)).astype(np.float32)
    b = rng.uniform(-5, 5, (70, 2)).astype(np.float32)
    np.testing.assert_allclose(tnn.pairwise_sqdist(_t(a), _t(b)).numpy(),
                               np.asarray(jnn.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b))), atol=1e-4)


@pytest.mark.parametrize("n,k", [(200, 20), (64, 5), (16, 30)])
def test_knn_indices_sets_equal(rng, n, k):
    xy, valid = _random_cloud(rng, n)
    jidx, jok = (np.asarray(x) for x in jnn.knn_indices(jnp.asarray(xy), jnp.asarray(valid), k))
    tidx, tok = (x.numpy() for x in tnn.knn_indices(_t(xy), _t(valid), k))
    assert tidx.shape == jidx.shape and tidx.dtype == np.int32
    np.testing.assert_array_equal(tok, jok)
    for i in range(n):
        assert set(tidx[i][tok[i]]) == set(jidx[i][jok[i]]), i
    assert (tidx[tok] != np.nonzero(tok)[0]).all(), "a point is not its own neighbour"


@pytest.mark.parametrize("seed", [3, 8])
def test_local_covariances(seed):
    xy, valid = _scan_cloud(seed)
    j = np.asarray(jnn.local_covariances(jnp.asarray(xy), jnp.asarray(valid), 20, 0.1))
    t = tnn.local_covariances(_t(xy), _t(valid), 20, 0.1).numpy()
    np.testing.assert_allclose(t, j, atol=1e-4)
    np.testing.assert_array_equal(t[~valid], np.broadcast_to(np.eye(2, dtype=np.float32), t[~valid].shape))


def test_local_covariances_at(rng):
    cloud, cvalid = _scan_cloud(5)
    queries = cloud[:128] + rng.normal(0, 15, (128, 2)).astype(np.float32)
    for eps in (1e-3, 0.1):
        j = np.asarray(jnn.local_covariances_at(jnp.asarray(queries), jnp.asarray(cloud), jnp.asarray(cvalid), 20, eps))
        t = tnn.local_covariances_at(_t(queries), _t(cloud), _t(cvalid), 20, eps).numpy()
        np.testing.assert_allclose(t, j, atol=1e-4)


def test_local_covariances_few_neighbours():
    """Fewer than three real members -> the identity."""
    xy = np.array([[0.0, 0.0], [100.0, 0.0], [0.0, 0.0], [0.0, 0.0]], np.float32)
    valid = np.array([True, True, False, False])
    t = tnn.local_covariances(_t(xy), _t(valid), 3).numpy()
    j = np.asarray(jnn.local_covariances(jnp.asarray(xy), jnp.asarray(valid), 3))
    np.testing.assert_allclose(t, j, atol=1e-6)
    np.testing.assert_array_equal(t[0], np.eye(2))


@pytest.mark.parametrize("n,k", [(512, 30), (40, 30), (8, 30)])
def test_knn_mean_distance(rng, n, k):
    xy, valid = _random_cloud(rng, n)
    j = np.asarray(jnn.knn_mean_distance(jnp.asarray(xy), jnp.asarray(valid), k))
    t = tnn.knn_mean_distance(_t(xy), _t(valid), k).numpy()
    np.testing.assert_allclose(t[valid], j[valid], atol=1e-2)
    assert (t[~valid] == np.float32(1e30)).all()


@pytest.mark.parametrize("seed", [1, 2, 4])
def test_statistical_outlier_mask(seed):
    xy, valid = _scan_cloud(seed)
    rng = np.random.default_rng(seed)
    far = rng.choice(np.flatnonzero(valid), 6, replace=False)
    xy[far] += rng.uniform(1500, 3000, (6, 2)).astype(np.float32)  # stray returns
    j = np.asarray(jout.statistical_outlier_mask(jnp.asarray(xy), jnp.asarray(valid), 30, 1.5))
    t = tout.statistical_outlier_mask(_t(xy), _t(valid), 30, 1.5).numpy()
    # a point may flip only when it sits within 0.05 mm of the threshold
    mean_knn = np.asarray(jnn.knn_mean_distance(jnp.asarray(xy), jnp.asarray(valid), 30))
    vals = mean_knn[valid]
    thresh = vals.mean() + 1.5 * vals.std()
    differ = t != j
    assert (np.abs(mean_knn[differ] - thresh) <= 0.05).all(), mean_knn[differ] - thresh
    assert differ.sum() <= 2
    assert 0 < (valid & ~t).sum() < 60 and not t[~valid].any()


def test_outlier_mask_batched_equals_rows():
    clouds = [_scan_cloud(s) for s in (1, 2, 4)]
    xy = _t(np.stack([c[0] for c in clouds]))
    valid = _t(np.stack([c[1] for c in clouds]))
    whole = tout.statistical_outlier_mask(xy, valid, 30, 1.5)
    for i in range(3):
        assert torch.equal(whole[i], tout.statistical_outlier_mask(xy[i], valid[i], 30, 1.5))
    cov = tnn.local_covariances(xy, valid, 20, 0.1)
    for i in range(3):
        np.testing.assert_allclose(cov[i].numpy(), tnn.local_covariances(xy[i], valid[i], 20, 0.1).numpy(), atol=1e-6)


def test_voxel_downsample_batched_matches_jax_and_rows(rng):
    xys = rng.uniform(-6000, 6000, (3, 512, 2)).astype(np.float32)
    valids = rng.random((3, 512)) < 0.8
    sizes = (30.0, 60.0, 250.0)
    jxy, jv = jvoxel.voxel_downsample_batched(jnp.asarray(xys), jnp.asarray(valids), sizes)
    txy, tv = tvoxel.voxel_downsample_batched(_t(xys), _t(valids), sizes)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), atol=1e-3)
    for i, size in enumerate(sizes):
        rxy, rv = tvoxel.voxel_downsample(_t(xys[i]), _t(valids[i]), size)
        assert torch.equal(rv, tv[i])
        np.testing.assert_allclose(rxy.numpy(), txy[i].numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="voxel sizes"):
        tvoxel.voxel_downsample_batched(_t(xys), _t(valids), (30.0, 60.0))


def test_voxel_downsample_leading_axes(rng):
    """One size, two leading axes (the realtime fleet's rows x robots)."""
    xys = rng.uniform(-3000, 3000, (2, 3, 128, 2)).astype(np.float32)
    valids = rng.random((2, 3, 128)) < 0.7
    txy, tv = tvoxel.voxel_downsample(_t(xys), _t(valids), 100.0)
    for r in range(2):
        for b in range(3):
            jxy, jv = jvoxel.voxel_downsample(jnp.asarray(xys[r, b]), jnp.asarray(valids[r, b]), 100.0)
            np.testing.assert_array_equal(tv[r, b].numpy(), np.asarray(jv))
            np.testing.assert_allclose(txy[r, b].numpy(), np.asarray(jxy), atol=1e-3)


@pytest.mark.parametrize("capacity", [96, 128, 200])
def test_compact_batched_equals_rows_and_jax(rng, capacity):
    xys = rng.uniform(-3000, 3000, (3, 128, 2)).astype(np.float32)
    valids = rng.random((3, 128)) < 0.6
    txy, tv = tvoxel.compact(_t(xys), _t(valids), capacity)
    assert txy.shape == (3, capacity, 2) and tv.shape == (3, capacity)
    for i in range(3):
        jxy, jv = jvoxel.compact(jnp.asarray(xys[i]), jnp.asarray(valids[i]), capacity)
        np.testing.assert_array_equal(tv[i].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(txy[i].numpy()[np.asarray(jv)], np.asarray(jxy)[np.asarray(jv)])
