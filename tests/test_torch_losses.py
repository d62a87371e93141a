"""The port's losses (`models/losses.py`) against the JAX package's, on
seeded head outputs at a 64 px input (84 anchors), with no model.

Tolerances: loss values within 1e-5 relative; gradients with respect to the
head outputs (``jax.grad`` against autograd) within 1e-4 of each tensor's
norm; the assigner's ``assigned_gt`` and foreground equal and its target
scores within 1e-6.  Both sides compute in float32 and sum in another
order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_slam_yolo_tpu.models import losses as jl
from icp_slam_yolo_tpu.models.yolo import make_anchors as j_anchors
from icp_slam_yolo_tpu_torch.models import losses as tl
from icp_slam_yolo_tpu_torch.models.yolo import make_anchors as t_anchors

torch.set_num_threads(2)
SIZE, B, M, C = 64, 2, 5, 2
EXTRA = {"detect": 0, "obb": 1, "segment": 32, "pose": 12}


def _gt(seed):
    """Ground truths: 4 valid boxes of 8-44 px an image and a padded one,
    classes 0/1, OBB angles, keypoints at the corners (one hidden) and
    masks at the proto resolution (16 x 16)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 30, (B, M, 2))
    wh = rng.uniform(8, 44, (B, M, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, SIZE)], -1).astype(np.float32)
    valid = np.ones((B, M), bool)
    valid[:, -1] = False
    boxes[~valid] = 0.0
    classes = rng.integers(0, C, (B, M)).astype(np.int32)
    angles = rng.uniform(-0.7, 2.3, (B, M)).astype(np.float32)
    corners = np.stack([boxes[..., [0, 1]], boxes[..., [2, 1]], boxes[..., [2, 3]], boxes[..., [0, 3]]], 2)
    vis = np.ones((B, M, 4, 1), np.float32)
    vis[:, :, 3] = 0.0
    kpts = np.concatenate([corners + rng.normal(0, 1.0, corners.shape), vis], -1).astype(np.float32)
    masks = (rng.random((B, M, 16, 16)) < 0.5).astype(np.float32)
    return {"boxes": boxes, "classes": classes, "valid": valid, "angles": angles, "kpts": kpts, "masks": masks}


def _heads(task, seed):
    """Per-level head outputs ``(B, S, S, E)`` for strides 8, 16, 32: box
    logits, class logits (biased low, as a young detector's), and the task's
    branch; segment also the prototypes ``(B, 16, 16, 32)``."""
    rng = np.random.default_rng(seed)
    levels = []
    for n in (8, 4, 2):
        level = [rng.normal(0, 1.5, (B, n, n, 64)), rng.normal(-1.0, 2.0, (B, n, n, C))]
        if EXTRA[task]:
            level.append(rng.normal(0, 1.0, (B, n, n, EXTRA[task])))
        levels.append([a.astype(np.float32) for a in level])
    protos = rng.normal(0, 1.0, (B, 16, 16, 32)).astype(np.float32)
    return levels, protos


def _jax_loss(task, levels, protos, gt):
    g = {k: jnp.asarray(v) for k, v in gt.items()}

    def f(lv, pr):
        outs = [tuple(level) for level in lv]
        if task == "segment":
            return jl.segmentation_loss(outs, pr, g["boxes"], g["classes"], g["valid"], g["masks"], SIZE, C)
        if task == "pose":
            return jl.pose_loss(outs, g["boxes"], g["classes"], g["valid"], g["kpts"], SIZE, C)
        return jl.detection_loss(outs, g["boxes"], g["classes"], g["valid"], SIZE, C,
                                 gt_angles=g["angles"] if task == "obb" else None)

    lv = [[jnp.asarray(a) for a in level] for level in levels]
    (total, metrics), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(lv, jnp.asarray(protos))
    return float(total), {k: float(v) for k, v in metrics.items()}, grads


def _port_loss(task, levels, protos, gt):
    g = {k: torch.from_numpy(v) for k, v in gt.items()}
    lv = [[torch.tensor(a, requires_grad=True) for a in level] for level in levels]
    pr = torch.tensor(protos, requires_grad=True)
    outs = [tuple(level) for level in lv]
    if task == "segment":
        total, metrics = tl.segmentation_loss(outs, pr, g["boxes"], g["classes"], g["valid"], g["masks"], SIZE, C)
    elif task == "pose":
        total, metrics = tl.pose_loss(outs, g["boxes"], g["classes"], g["valid"], g["kpts"], SIZE, C)
    else:
        total, metrics = tl.detection_loss(outs, g["boxes"], g["classes"], g["valid"], SIZE, C,
                                           gt_angles=g["angles"] if task == "obb" else None)
    total.backward()
    return float(total.detach()), {k: float(v) for k, v in metrics.items()}, ([[a.grad for a in level] for level in lv], pr.grad)


def test_ciou_matches_jax_with_gradients():
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 50, (2, 64, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.5, 30, (2, 64, 2))], -1).astype(np.float32)
    a, b = boxes[0], boxes[1]
    want, (ga, gb) = jax.value_and_grad(lambda x, y: jnp.sum(jl.ciou(x, y) * jnp.arange(64.0)), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    got = torch.sum(tl.ciou(ta, tb) * torch.arange(64.0))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for t, j in ((ta.grad, ga), (tb.grad, gb)):
        assert np.linalg.norm(t.numpy() - np.asarray(j)) <= 1e-4 * np.linalg.norm(np.asarray(j))
    np.testing.assert_allclose(tl.ciou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jl.ciou(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_task_aligned_assign_matches_jax(seed):
    rng = np.random.default_rng(seed)
    anchors_j, _ = j_anchors(SIZE)
    anchors_t, _ = t_anchors(SIZE)
    a = anchors_t.shape[0]
    gt = _gt(seed + 10)
    scores = rng.uniform(0.0, 1.0, (B, a, C)).astype(np.float32)
    centre = anchors_t.numpy()[None]
    half = rng.uniform(2, 20, (B, a, 2))
    pred = np.concatenate([centre - half, centre + half], -1).astype(np.float32)
    got = tl.task_aligned_assign(torch.from_numpy(scores), torch.from_numpy(pred), anchors_t,
                                 torch.from_numpy(gt["boxes"]), torch.from_numpy(gt["classes"]),
                                 torch.from_numpy(gt["valid"]))
    for i in range(B):
        want = jl.task_aligned_assign(jnp.asarray(scores[i]), jnp.asarray(pred[i]), anchors_j,
                                      jnp.asarray(gt["boxes"][i]), jnp.asarray(gt["classes"][i]),
                                      jnp.asarray(gt["valid"][i]))
        assert np.array_equal(got[1][i].numpy(), np.asarray(want[1]))
        assert int(got[1][i].sum()) > 0
        assert np.array_equal(got[0][i].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[2][i].numpy(), np.asarray(want[2]), atol=1e-6)


@pytest.mark.parametrize("task", ["detect", "obb", "segment", "pose"])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradients_match_jax(task, seed):
    levels, protos = _heads(task, seed)
    gt = _gt(seed + 20)
    jt, jm, (jg_levels, jg_protos) = _jax_loss(task, levels, protos, gt)
    tt, tm, (tg_levels, tg_protos) = _port_loss(task, levels, protos, gt)
    assert tm["num_fg"] == jm["num_fg"] > 0
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tt, jt, rtol=1e-5)
    pairs = [(t, j) for tlv, jlv in zip(tg_levels, jg_levels) for t, j in zip(tlv, jlv)]
    if task == "segment":
        pairs.append((tg_protos, jg_protos))
    for t, j in pairs:
        j = np.asarray(j)
        assert np.linalg.norm(t.numpy() - j) <= 1e-4 * np.linalg.norm(j), (task, np.linalg.norm(t.numpy() - j))


def test_saturated_logits_keep_finite_gradients():
    """The assigner's outputs carry no gradient: with class logits saturated
    (sigmoid exactly 0 in float32), ``d sqrt(score)`` would be infinite."""
    levels, protos = _heads("detect", 5)
    for level in levels:
        level[1][:] = -200.0
    _, _, (grads, _) = _port_loss("detect", levels, protos, _gt(5))
    assert all(bool(torch.isfinite(g).all()) for level in grads for g in level)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mask_selection_breaks_ties_as_lax_top_k(seed):
    """The segment loss takes the top 64 anchors by weight with
    `top_k_stable`; equal weights straddle the 64th place here (runs of
    ties, zeros among them), and the selection must be ``lax.top_k``'s:
    the lower index first."""
    rng = np.random.default_rng(seed)
    w = rng.choice(np.array([0.0, 0.25, 0.5, 0.75], np.float32), size=(B, 84), p=[0.3, 0.3, 0.2, 0.2])
    jv, ji = jax.lax.top_k(jnp.asarray(w), 64)
    tv, ti = tl.top_k_stable(torch.from_numpy(w), 64)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    kth = np.sort(w, axis=1)[:, ::-1][:, 63]
    assert all((w[i] == kth[i]).sum() > 1 for i in range(B))  # a tie does straddle the cut
