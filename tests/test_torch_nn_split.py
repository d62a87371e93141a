"""The layouts of K3 (`nn_plan`) and K1 (`icp_plan`), and Python models of
how the two kernels merge partial nearest neighbours when the targets are
split: K3's slice-wise minima merged in (d², index) order (lanes, warps,
cluster ranks in order), K1's packed 64-bit keys ``(d² bits << 32) | index``
min-reduced.  The models are held equal to the plain version and to the JAX
Pallas kernel in interpret mode on tie-heavy inputs, bit for bit (every
version takes d² in the same difference form), and K1's moments, summed in
the kernel's row order and tree, are held equal whatever the number of
slices.  The CUDA kernels themselves run only on the card (`chip_smoke.py`
forces every layout there and requires the same bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_slam_yolo_tpu.ops.pallas.nn_kernel import nn_argmin_pallas
from icp_slam_yolo_tpu_torch.ops.pallas import icp_fused as k1
from icp_slam_yolo_tpu_torch.ops.pallas.nn_kernel import CLUSTERS, LANES, MIN_SLICE, nn_argmin_plain, nn_plan

torch.set_num_threads(2)

BIG = np.float32(1e30)
FAR = np.float32(1e18)
CHUNK = 4096  # targets K3 stages at a time (csrc/nn.cu kChunk)


def _d2(src, tgt, valid):
    """(S, T) float32 d² in the kernels' difference form, invalid targets at
    the far coordinates the kernels stage them at."""
    t = np.where(valid[:, None], tgt, FAR).astype(np.float32)
    dx = src[:, None, 0] - t[None, :, 0]
    dy = src[:, None, 1] - t[None, :, 1]
    return dx * dx + dy * dy


def _first_min(d2, cols):
    """Strict-< scan in increasing index over ``cols``: ``(best, arg)`` per row."""
    best = np.full(d2.shape[0], BIG, np.float32)
    arg = np.full(d2.shape[0], np.iinfo(np.int32).max, np.int64)
    if len(cols):
        sub = d2[:, cols]
        j = np.argmin(sub, axis=1)  # first occurrence
        v = sub[np.arange(len(j)), j]
        take = v < best
        best[take], arg[take] = v[take], np.asarray(cols)[j[take]]
    return best, arg


def _merge(parts):
    """Merge partial minima in the given order, the lower index on equal d²."""
    best, arg = parts[0]
    best, arg = best.copy(), arg.copy()
    for b, a in parts[1:]:
        take = (b < best) | ((b == best) & (a < arg))
        best, arg = np.where(take, b, best), np.where(take, a, arg)
    return best, arg


def k3_model(src, tgt, valid, lanes, cluster):
    """K3's layout on one problem: rank r of the cluster owns the r-th
    contiguous slice; in it, part p of the block's 8 * 32 / lanes parts takes
    the targets p, p + P, ... of each staged chunk; parts merge in part
    order, ranks in rank order.  Returns ``(d², index)`` as the kernel writes
    them."""
    t = tgt.shape[0]
    d2 = _d2(src, tgt, valid)
    n_parts = 8 * 32 // lanes
    slice_len = -(-t // cluster)
    ranks = []
    for r in range(cluster):
        t0, t1 = r * slice_len, min(t, (r + 1) * slice_len)
        cols = [[] for _ in range(n_parts)]
        for c0 in range(t0, t1, CHUNK):
            for k in range(min(CHUNK, t1 - c0)):
                cols[k % n_parts].append(c0 + k)
        ranks.append(_merge([_first_min(d2, c) for c in cols]))
    best, arg = _merge(ranks)
    return best, np.where(best < BIG, arg, 0).astype(np.int32)


def _keys(best, idx):
    """K1's packed keys: d² bits (non-negative floats order as integers)
    above the index; "no match" is the largest key."""
    key = (best.view(np.int32).astype(np.int64) << 32) | idx.astype(np.int64)
    return np.where(best < BIG, key, np.iinfo(np.int64).max)


def k1_keys(src, tgt, valid, slices):
    """K1's sweep: the valid targets split into ``slices`` equal runs by
    their rank, each block's first minimum over its run as a key, the keys
    min-reduced (an atomicMin)."""
    order = np.flatnonzero(valid)
    d2 = _d2(src, tgt, valid)
    nv = len(order)
    keys = np.full(src.shape[0], np.iinfo(np.int64).max, np.int64)
    for s in range(slices):
        cols = order[nv * s // slices: nv * (s + 1) // slices]
        best, arg = _first_min(d2, cols)
        keys = np.minimum(keys, _keys(best, arg))
    return keys


def _tree32(x):
    """A warp's `__shfl_down_sync` tree (offsets 16 ... 1): lane 0's sum."""
    x = x.copy()
    for off in (16, 8, 4, 2, 1):
        x[: 32 - off] = x[: 32 - off] + x[off:32]
    return x[0]


def k1_moments(src, src_valid, tgt, keys, thr2):
    """K1's eight moments from the keys, summed as every block sums them:
    thread t adds rows t, t + 256, ... in order, then `block_sum8`'s tree."""
    per_thread = np.zeros((256, 8), np.float32)
    for i in np.flatnonzero(src_valid):
        terms = np.zeros(8, np.float32)
        if keys[i] != np.iinfo(np.int64).max:
            t = tgt[int(keys[i] & 0xFFFFFFFF)]
            dx, dy = src[i, 0] - t[0], src[i, 1] - t[1]
            d2 = dx * dx + dy * dy
            if d2 < thr2:
                pxm, pym, mxm, mym = (np.float32(v) * np.float32(1e-3) for v in (src[i, 0], src[i, 1], t[0], t[1]))
                terms = np.array([1.0, pxm, pym, mxm, mym, pxm * mxm + pym * mym, pxm * mym - pym * mxm,
                                  np.sqrt(d2)], np.float32)
        per_thread[i % 256] += terms
    warps = np.stack([np.array([_tree32(per_thread[32 * w: 32 * w + 32, k]) for k in range(8)], np.float32)
                      for w in range(8)])
    return np.array([_tree32(np.concatenate([warps[:, k], np.zeros(24, np.float32)])) for k in range(8)], np.float32)


def _tie_heavy(seed, s=64, t=1024, cluster=8):
    """Targets duplicated T/2 apart (each tie straddles slices), one cluster
    slice with no valid target, coarse coordinates (more ties)."""
    rng = np.random.default_rng(seed)
    half = (np.round(rng.uniform(-3000, 3000, (t // 2, 2)) / 250.0) * 250.0).astype(np.float32)
    tgt = np.concatenate([half, half])
    valid = rng.random(t) < 0.85
    slice_len = t // cluster
    valid[2 * slice_len: 3 * slice_len] = False
    src = (np.round(rng.uniform(-3000, 3000, (s, 2)) / 125.0) * 125.0).astype(np.float32)
    return src, tgt, valid


@pytest.mark.parametrize("b,s,t,want", [
    (1, 512, 512, (4, 1)),      # the step's dynamic-point filter: never split
    (8, 512, 512, (4, 1)),      # the fleet's at B = 8
    (64, 512, 512, (16, 1)),    # at B = 64: 512 blocks of 64 points, no split
    (1, 512, 24576, (4, 8)),    # the GICP rescue: 32 tiles x 8 ranks = 256 blocks
    (1, 512, 2048, (4, 1)),     # a slice would keep fewer than MIN_SLICE targets
    (1, 512, 4096, (4, 2)),
    (1, 512, 8192, (4, 4)),
])
def test_nn_plan(b, s, t, want):
    lanes, cluster = nn_plan(b, s, t, 132)
    assert (lanes, cluster) == want
    assert lanes in LANES and cluster in CLUSTERS
    if cluster > 1:
        assert t // cluster >= MIN_SLICE
        assert b * -(-s // 16) * cluster // 2 < 132, "split no further than one block a multiprocessor"


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_k3_merge_model_matches_plain_and_pallas(lanes, cluster, seed):
    src, tgt, valid = _tie_heavy(seed)
    md, mi = k3_model(src, tgt, valid, lanes, cluster)
    pd, pi = nn_argmin_plain(*(torch.from_numpy(x)[None] for x in (src, tgt, valid)))
    jd, ji = nn_argmin_pallas(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid), interpret=True)
    np.testing.assert_array_equal(mi, pi[0].numpy())
    np.testing.assert_array_equal(md, pd[0].numpy())
    np.testing.assert_array_equal(mi, np.asarray(ji))
    np.testing.assert_array_equal(md, np.asarray(jd))
    # each tie resolved to the first copy when both are valid
    both = valid[: len(valid) // 2] & valid[len(valid) // 2:]
    assert not np.isin(mi, np.flatnonzero(both) + len(valid) // 2).any()


def test_k3_merge_model_with_no_valid_target():
    src, tgt, _ = _tie_heavy(2)
    valid = np.zeros(len(tgt), bool)
    for lanes in LANES:
        md, mi = k3_model(src, tgt, valid, lanes, 8)
        jd, ji = nn_argmin_pallas(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid), interpret=True)
        np.testing.assert_array_equal(md, np.asarray(jd))
        np.testing.assert_array_equal(mi, np.asarray(ji))
        assert (md == BIG).all() and (mi == 0).all()


def test_k3_merge_model_across_chunks():
    """A slice longer than one staged chunk: the parts run on across chunks."""
    src, tgt, valid = _tie_heavy(3, s=16, t=2 * CHUNK + 256, cluster=1)
    md, mi = k3_model(src, tgt, valid, 4, 1)
    pd, pi = nn_argmin_plain(*(torch.from_numpy(x)[None] for x in (src, tgt, valid)))
    np.testing.assert_array_equal(mi, pi[0].numpy())
    np.testing.assert_array_equal(md, pd[0].numpy())


@pytest.mark.parametrize("slices", [1, 3, 8, 64])
def test_k1_keys_match_plain_argmin(slices):
    src, tgt, valid = _tie_heavy(4, s=128, t=1024)
    keys = k1_keys(src, tgt, valid, slices)
    pd, pi = nn_argmin_plain(*(torch.from_numpy(x)[None] for x in (src, tgt, valid)))
    np.testing.assert_array_equal(keys, _keys(pd[0].numpy(), pi[0].numpy()))


def test_k1_moments_do_not_depend_on_the_slices():
    """The moments, summed in row order and the fixed tree, are the same bits
    for every split of the targets, and agree with the plain version's
    moments (summed in PyTorch's order) to float32 rounding."""
    rng = np.random.default_rng(6)
    src, tgt, valid = _tie_heavy(6, s=300, t=2048)
    src = src + rng.normal(0, 30, src.shape).astype(np.float32)
    src_valid = rng.random(len(src)) < 0.9
    thr2 = np.float32(200.0 ** 2)
    ref = k1_moments(src, src_valid, tgt, k1_keys(src, tgt, valid, 1), thr2)
    for slices in (2, 7, 33, 200):
        np.testing.assert_array_equal(k1_moments(src, src_valid, tgt, k1_keys(src, tgt, valid, slices), thr2), ref)
    d2, idx = nn_argmin_plain(*(torch.from_numpy(x)[None] for x in (src, tgt, valid)))
    d2, idx = d2[0].numpy(), idx[0].numpy()
    w = src_valid & (d2 < thr2)
    m = tgt[idx]
    assert ref[0] == w.sum()
    np.testing.assert_allclose(ref[1], (src[w, 0] * 1e-3).sum(), rtol=1e-5)
    np.testing.assert_allclose(ref[4], (m[w, 1] * 1e-3).sum(), rtol=1e-5)
    np.testing.assert_allclose(ref[7], np.sqrt(d2[w]).sum(), rtol=1e-5)


def _blocks_per_sm(smem):
    """A stand-in for the card's occupancy: 3 blocks a multiprocessor by
    registers, fewer when 233472 bytes of shared memory do not hold them."""
    return min(3, 233472 // (smem + 9216 + 1024))


def _clusters(blocks, smem):
    """Clusters of ``blocks`` blocks that fit at once: a cluster's blocks sit
    on the 16 multiprocessors of one of 8 processor clusters (none above 16)."""
    return 0 if blocks > 16 else 8 * (16 * _blocks_per_sm(smem) // blocks)


CARD = k1.Card(132, _blocks_per_sm, _clusters)


@pytest.mark.parametrize("b,t,want", [
    (1, 24576, (4, 33, False)),   # one registration: a block a multiprocessor, one sweep pass a block
    (8, 24576, (4, 8, False)),    # eight: two blocks a multiprocessor shared out
    (1, 256, (4, 4, False)),      # few targets: at least MIN_TARGETS a slice
    (64, 24576, (2, 8, True)),    # a cluster of 16 a registration, clusters in turn
    (200, 24576, (2, 8, True)),   # more registrations than the card holds at once
])
def test_icp_plan(b, t, want):
    plan = k1.icp_plan(b, 512, t, CARD)
    assert (plan.row_groups, plan.slices, plan.cluster) == want
    assert plan.smem == k1.smem_bytes(512, t, plan.slices)
    assert k1.plan_fits(b, 512, t, CARD, plan.row_groups, plan.slices, plan.cluster)
    assert plan.slices == 1 or -(-t // plan.slices) >= k1.MIN_TARGETS
    if not plan.cluster:
        assert b * plan.row_groups * plan.slices <= 132 * _blocks_per_sm(plan.smem), "every block resident"
        assert -(-512 // plan.row_groups) <= k1.ROWS_A_PASS, "one sweep pass a block"


def test_icp_plan_forced_and_refused():
    """`layouts` lists the grid and cluster layouts that fit, each passing
    `plan_fits` (the test `icp_fused` holds a given plan to); one that does
    not fit is neither listed nor passes it; nothing fits: `icp_plan` raises."""
    listed = [p[:3] for p in k1.layouts(8, 512, 24576, CARD)]
    assert (2, 16, False) in listed and (2, 4, True) in listed
    assert k1.plan_fits(8, 512, 24576, CARD, 1, 8, True)
    assert all(k1.plan_fits(8, 512, 24576, CARD, *p) for p in listed)
    # the grid layout needs every block resident
    assert not k1.plan_fits(64, 512, 24576, CARD, 1, 64, False)
    assert (1, 64, False) not in [p[:3] for p in k1.layouts(64, 512, 24576, CARD)]
    assert not k1.plan_fits(1, 512, 24576, CARD, 2, 16, True)  # no cluster above 16 blocks
    with pytest.raises(ValueError, match="do not fit"):  # 15 grid-layout registrations of 24576 targets exceed the card
        k1.icp_plan(15, 512, 24576, k1.Card(20, _blocks_per_sm, _clusters))
