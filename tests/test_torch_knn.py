"""k-NN, local covariances, the statistical outlier filter and the batched
voxel ops: the port vs the JAX package on seeded numpy inputs, on the CPU
(where the JAX side takes its exact ``top_k``, the path the port mirrors).
The filter's kernel (K9) runs only on the card; here its wrapper's checks
and limits and its plain version's edge rows.

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
from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops import voxel as tvoxel
from icp_slam_yolo_tpu_torch.ops.pallas import knn_kernel as tknn

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
    t = tknn.knn_mean_distance(_t(xy), _t(valid), k).numpy()
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
    before = pallas.LAUNCHES["knn_outlier"]
    tout.statistical_outlier_mask(xy[None], valid[None], 30, 1.5)
    assert pallas.LAUNCHES["knn_outlier"] == before, "a CPU call launches no kernel"
    cov = tnn.local_covariances(xy, valid, 20, 0.1)
    for i in range(3):
        np.testing.assert_allclose(cov[i].numpy(), tnn.local_covariances(xy[i], valid[i], 20, 0.1).numpy(), atol=1e-6)


@pytest.mark.parametrize("k", [30, 33, 40, 64])
@pytest.mark.parametrize("n", [40, 512, 2100])
def test_knn_outlier_cpu_any_k_and_slots(rng, k, n):
    """On CPU tensors the filter takes any ``k`` and ``N``, the kernel's
    limits (``k`` <= 32, ``N`` <= 2048) included, and stays the JAX
    package's: means within 1e-2 mm, masks equal but within 0.05 mm of the
    threshold, at most 2 such points."""
    xy, valid = _random_cloud(rng, n)
    mean, keep = (x.numpy() for x in tknn.knn_outlier(_t(xy[None]), _t(valid[None]), k, 1.5))
    j = np.asarray(jnn.knn_mean_distance(jnp.asarray(xy), jnp.asarray(valid), k))
    np.testing.assert_allclose(mean[0][valid], j[valid], atol=1e-2)
    jkeep = np.asarray(jout.statistical_outlier_mask(jnp.asarray(xy), jnp.asarray(valid), k, 1.5))
    thresh = j[valid].mean() + 1.5 * j[valid].std()
    differ = keep[0] != jkeep
    assert (np.abs(j[differ] - thresh) <= 0.05).all() and differ.sum() <= 2
    np.testing.assert_array_equal(tout.statistical_outlier_mask(_t(xy), _t(valid), k, 1.5).numpy(), keep[0])
    if k > tknn.MAX_K or n > tknn.MAX_N:
        with pytest.raises(ValueError):
            tknn.check_supported(k, n, "cuda")
    else:
        tknn.check_supported(k, n, "cuda")


def test_check_supported_config_k9_limits():
    """A configuration beyond the kernel's limits is refused when the card is
    named, at construction, and runs on the CPU."""
    from icp_slam_yolo_tpu_torch.config import SlamConfig
    from icp_slam_yolo_tpu_torch.slam import pipeline

    wide = SlamConfig(use_outlier_filter=True, outlier_nb_neighbors=40)
    for cfg in (wide, SlamConfig(use_outlier_filter=True, n_max=tknn.MAX_N + 8)):
        with pytest.raises(ValueError):
            pipeline.check_supported_config(cfg, "cuda")
        pipeline.check_supported_config(cfg, "cpu")
        pipeline.check_supported_config(cfg)
    pipeline.check_supported_config(SlamConfig(use_outlier_filter=True), "cuda")
    pipeline.check_supported_config(wide.replace(use_outlier_filter=False), "cuda")


@pytest.mark.parametrize("case", ["xy_dtype", "valid_dtype", "xy_shape", "valid_shape", "k_large", "k_zero",
                                  "slots", "strided"])
def test_knn_outlier_argument_checks(rng, case):
    xy, valid = _t(rng.uniform(-1000, 1000, (2, 64, 2)).astype(np.float32)), _t(rng.random((2, 64)) < 0.8)
    k, err = 30, ValueError
    if case == "xy_dtype":
        xy, err = xy.double(), TypeError
    elif case == "valid_dtype":
        valid, err = valid.to(torch.uint8), TypeError
    elif case == "xy_shape":
        xy = torch.cat([xy, xy[..., :1]], dim=-1)
    elif case == "valid_shape":
        valid = valid[:, :63]
    elif case == "k_large":  # the card's limit; the CPU's plain version takes any k
        with pytest.raises(err):
            tknn.check_supported(tknn.MAX_K + 1, 64, "cuda")
        return
    elif case == "k_zero":
        k = 0
    elif case == "slots":  # the card's limit, as k's
        with pytest.raises(err):
            tknn.check_supported(30, tknn.MAX_N + 1, "cuda")
        return
    else:
        xy = xy.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(err):
        tknn.knn_outlier(xy, valid, k, 1.5)


def _brute_mean(xy, valid, k):
    """Mean distance (mm) to the up to ``k`` nearest other valid points, in
    float64 (0 with no neighbour, 1e30 where invalid)."""
    out = np.full(len(xy), 1e30)
    idx = np.flatnonzero(valid)
    for i in idx:
        d = np.sort(np.hypot(*(xy[idx] - xy[i]).astype(np.float64).T))
        d = np.delete(d, np.searchsorted(d, 0.0))  # itself (a duplicate may also sit at 0)
        out[i] = d[:k].mean() if len(d) else 0.0
    return out


def test_knn_outlier_plain_edge_rows(rng):
    """Rows with no valid point, one, fewer than k, duplicated points (ties)
    and a stray return, in one batch: each row as alone and as a float64
    brute force has it, and the keep-mask by its own statistics."""
    n, k = 64, 30
    xy = rng.uniform(-3000, 3000, (5, n, 2)).astype(np.float32)
    valid = rng.random((5, n)) < 0.9
    valid[0] = False
    valid[1] = False
    valid[1, 17] = True
    valid[2] = False
    valid[2, [3, 9, 20, 40, 41]] = True
    xy[3, 1::2] = xy[3, ::2]  # every point twice
    valid[3] = True
    xy[4, 5] = [40000.0, -40000.0]
    valid[4, 5] = True
    mean, keep = tknn.knn_outlier(_t(xy), _t(valid), k, 1.5)
    mean, keep = mean.numpy(), keep.numpy()
    for r in range(5):
        m1, k1 = tknn.knn_outlier(_t(xy[r:r + 1]), _t(valid[r:r + 1]), k, 1.5)
        np.testing.assert_array_equal(m1[0].numpy(), mean[r])
        np.testing.assert_array_equal(k1[0].numpy(), keep[r])
        np.testing.assert_allclose(mean[r][valid[r]], _brute_mean(xy[r], valid[r], k)[valid[r]], atol=2e-2)
    assert (mean[~valid] == np.float32(1e30)).all() and not keep[~valid].any()
    assert not keep[0].any()
    assert mean[1, 17] == 0.0 and keep[1, 17]
    assert (mean[3] > 0).all(), "a duplicate is a neighbour at 0 among others"
    assert not keep[4, 5] and keep[4].sum() > 40
    vals = mean[4][valid[4]].astype(np.float64)
    thr = np.float32(vals.mean()) + np.float32(1.5) * np.float32(vals.std())
    np.testing.assert_array_equal(keep[4][valid[4]], mean[4][valid[4]] <= thr)


def test_knn_outlier_plain_order_free(rng):
    """The plain version's float64 sums make a point's mean and the mask
    independent of slot order and of what invalid slots hold: what lets the
    kernel compact the valid points and sum in its own order."""
    xy, valid = _scan_cloud(6)
    mean, keep = tknn.knn_outlier(_t(xy[None]), _t(valid[None]), 30, 1.5)
    perm = rng.permutation(len(xy))
    junk = np.where(valid[:, None], xy, rng.uniform(-9e3, 9e3, xy.shape).astype(np.float32))
    mean_p, keep_p = tknn.knn_outlier(_t(junk[perm][None]), _t(valid[perm][None]), 30, 1.5)
    np.testing.assert_array_equal(mean_p[0].numpy(), mean[0].numpy()[perm])
    np.testing.assert_array_equal(keep_p[0].numpy(), keep[0].numpy()[perm])


def _kernel_order(xy, valid, k, ratio, kmax=32):
    """csrc/knn.cu's arithmetic in numpy float32: compaction, the centre in
    float64, the candidates outward from each query (q + 1, q - 1, ...), a
    sorted list of ``kmax`` with ``kmax - k`` slots of -1, the float64 sums."""
    f = np.float32
    idx = np.flatnonzero(valid)
    m = len(idx)
    c = (xy[idx].astype(np.float64).sum(0) / max(m, 1)).astype(f)
    p = (xy[idx] - c) * f(1e-3)
    sn = p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]
    top = np.full((m, kmax), f(1e30), f)
    top[:, : kmax - k] = -1.0
    q = np.arange(m)
    offsets = [o for s in range(1, (m - 1) // 2 + 1) for o in (s, -s)] + ([m // 2] if m > 1 and m % 2 == 0 else [])
    for o in offsets:
        j = (q + o) % m
        cross = p[q, 0] * p[j, 0] + p[q, 1] * p[j, 1]
        d = np.maximum((sn[q] + sn[j]) - f(2.0) * cross, f(0.0))
        top = np.sort(np.concatenate([top, d[:, None]], axis=1), axis=1)[:, :kmax]
    real = (top >= 0) & (top < 1e29)
    dk = np.where(real, np.sqrt(np.where(real, top, 0)) * f(1e3), 0).astype(np.float64)
    mk = (dk.sum(1) / np.maximum(real.sum(1), 1)).astype(f)
    mu = f(mk.astype(np.float64).sum() / max(m, 1))
    dev = mk - mu
    var = f((dev * dev).astype(np.float64).sum() / max(m, 1))
    mean = np.full(len(xy), f(1e30), f)
    mean[idx] = mk
    return mean, valid & (mean <= mu + f(ratio) * np.sqrt(var))


@pytest.mark.parametrize("seed", [2, 9])
def test_knn_outlier_plain_equals_kernel_order(rng, seed):
    """The kernel's order of work (numpy emulation) gives the plain
    version's bits, on a gated scan with stray returns and duplicates."""
    xy, valid = _scan_cloud(seed)
    far = rng.choice(np.flatnonzero(valid), 4, replace=False)
    xy[far] += 2500.0
    xy[np.flatnonzero(valid)[:6:2]] = xy[np.flatnonzero(valid)[1:6:2]]
    mean, keep = tknn.knn_outlier(_t(xy[None]), _t(valid[None]), 30, 1.5)
    mean_e, keep_e = _kernel_order(xy, valid, 30, 1.5)
    np.testing.assert_array_equal(mean[0].numpy(), mean_e)
    np.testing.assert_array_equal(keep[0].numpy(), keep_e)


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
