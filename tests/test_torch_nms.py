"""Decode and NMS of the port against the JAX package: `decode_topk`,
`decode_predictions`, `nms`, `suppress`, `box_iou`, `best_class`, on the
cases of `tests/test_yolo.py` (ties, suppression chains) with a batch axis
written out.  float32 on both sides: boxes to 1e-4 px, scores to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_slam_yolo_tpu.models import yolo as jyolo
from icp_slam_yolo_tpu.ops import nms as jnms
from icp_slam_yolo_tpu_torch.models import yolo as tyolo
from icp_slam_yolo_tpu_torch.ops import nms as tnms

torch.set_num_threads(2)
SIZE = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _head_outs(task, seed, bsz=2, num_classes=3, ties=False):
    """Random raw head outputs at 64 px (8x8, 4x4, 2x2 levels)."""
    rng = np.random.default_rng(seed)
    extra = {"detect": 0, "obb": 1, "segment": 32, "pose": 12}[task]
    outs = []
    for n in (8, 4, 2):
        box = rng.standard_normal((bsz, n, n, 64)).astype(np.float32)
        cls = (rng.standard_normal((bsz, n, n, num_classes)) * 2).astype(np.float32)
        if ties:
            cls = np.round(cls)  # many equal confidences and equal classes within an anchor
        level = (box, cls) + ((rng.standard_normal((bsz, n, n, extra)).astype(np.float32),) if extra else ())
        outs.append(level)
    return outs


def _both(outs):
    return [tuple(jnp.asarray(a) for a in lv) for lv in outs], [tuple(_t(a) for a in lv) for lv in outs]


def _cmp(got, want, atol):
    if want is None:
        assert got is None
    elif np.asarray(want).dtype.kind in "ib":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=1e-6)


def test_anchors_and_dfl():
    ja, js = jyolo.make_anchors(SIZE)
    ta, ts = tyolo.make_anchors(SIZE)
    _cmp(ta, ja, 0)
    _cmp(ts, js, 0)
    logits = np.random.default_rng(0).standard_normal((2, 5, 64)).astype(np.float32) * 3
    _cmp(tyolo.dfl_decode(_t(logits)), jyolo.dfl_decode(jnp.asarray(logits)), 1e-5)


@pytest.mark.parametrize("task", ["detect", "obb", "segment", "pose"])
def test_decode_predictions_matches_jax(task):
    jo, to = _both(_head_outs(task, 1))
    want = jyolo.decode_predictions(jo, SIZE, task=task)
    got = tyolo.decode_predictions(to, SIZE, task=task)
    for g, w in zip(got, want):
        _cmp(g, w, 1e-4)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("task", ["detect", "obb", "segment", "pose"])
def test_decode_topk_matches_jax(task, ties):
    """Same candidates in the same order, also where confidences tie (the
    lower anchor index first, the first class within an anchor)."""
    jo, to = _both(_head_outs(task, 2, ties=ties))
    want = jyolo.decode_topk(jo, SIZE, 20, task=task)
    got = tyolo.decode_topk(to, SIZE, 20, task=task)
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.int32
    for g, w in zip(got, want):
        _cmp(g, w, 1e-4)


def test_decode_topk_taskless_fallback():
    jo, to = _both(_head_outs("obb", 3))
    _cmp(tyolo.decode_topk(to, SIZE, 10)[4], jyolo.decode_topk(jo, SIZE, 10)[4], 1e-6)


def test_box_iou_and_best_class():
    rng = np.random.default_rng(4)
    a = np.sort(rng.uniform(0, 50, (2, 7, 2, 2)), axis=2).transpose(0, 1, 3, 2).reshape(2, 7, 4).astype(np.float32)
    a = a[..., [0, 2, 1, 3]]  # xyxy with x1 <= x2, y1 <= y2
    a[0, 3] = a[0, 2]         # identical boxes
    a[1, 4, 2:] = a[1, 4, :2]  # a degenerate box
    for i in range(2):
        _cmp(tnms.box_iou(_t(a), _t(a))[i], jnms.box_iou(jnp.asarray(a[i]), jnp.asarray(a[i])), 1e-6)
    s = np.round(rng.uniform(0, 1, (2, 9, 3)), 1).astype(np.float32)  # ties within a row
    conf, cls = tnms.best_class(_t(s))
    for i in range(2):
        jc, jk = jnms.best_class(jnp.asarray(s[i]))
        _cmp(conf[i], jc, 0)
        _cmp(cls[i], jk, 0)


def _dense_case(rng, n=64):
    centers = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(5, 25, (n, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], axis=1).astype(np.float32)
    return boxes, rng.uniform(0.1, 1.0, n).astype(np.float32), rng.integers(0, 2, n).astype(np.int32)


def _assert_detections_equal(got: tnms.Detections, want: list):
    """``want``: one JAX Detections per image."""
    for i, w in enumerate(want):
        for field in tnms.Detections._fields:
            _cmp(getattr(got, field)[i], getattr(w, field), 1e-5)


def test_nms_matches_jax_on_dense_fields_with_chains():
    """Dense random overlapping boxes (deep suppression chains), five images
    as one batch."""
    rng = np.random.default_rng(7)
    cases = [_dense_case(rng) for _ in range(5)]
    want = [jnms.nms(*(jnp.asarray(a) for a in c), conf_threshold=0.3, iou_threshold=0.4, max_detections=32)
            for c in cases]
    got = tnms.nms(*(_t(np.stack(a)) for a in zip(*cases)), conf_threshold=0.3, iou_threshold=0.4, max_detections=32)
    _assert_detections_equal(got, want)
    assert int(got.valid.sum()) > 20


@pytest.mark.parametrize("rounds", [1, 4])
def test_chain_unsuppression_and_round_grouping(rounds, monkeypatch):
    """A kills B, so B cannot kill C: greedy keeps A and C.  The result does
    not depend on how many rounds run between two convergence checks."""
    monkeypatch.setattr(tnms, "ROUNDS_PER_CHECK", rounds)
    boxes = np.array([[[0.0, 0, 10, 10], [6, 0, 16, 10], [12, 0, 22, 10]]], np.float32)
    scores = np.array([[0.9, 0.8, 0.7]], np.float32)
    classes = np.zeros((1, 3), np.int32)
    got = tnms.nms(_t(boxes), _t(scores), _t(classes), conf_threshold=0.25, iou_threshold=0.2, max_detections=3)
    want = jnms.nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), jnp.asarray(classes[0]),
                    conf_threshold=0.25, iou_threshold=0.2, max_detections=3)
    _assert_detections_equal(got, [want])
    assert got.valid[0].tolist() == [True, False, True]
    # a chain as long as the candidate list: box i overlaps only i-1 and i+1
    n = 12
    x0 = np.arange(n, dtype=np.float32) * 6
    chain = np.stack([x0, np.zeros(n, np.float32), x0 + 10, np.full(n, 10, np.float32)], axis=1)[None]
    sc = np.linspace(0.9, 0.3, n, dtype=np.float32)[None]
    got = tnms.nms(_t(chain), _t(sc), _t(np.zeros((1, n), np.int32)), 0.25, 0.2, n)
    assert got.valid[0].tolist() == [i % 2 == 0 for i in range(n)]


def test_ties_and_anchor_idx():
    """Equal scores keep the lower index first; anchor_idx points back into
    the flat candidate axis; rows below the threshold are invalid with -1."""
    boxes = np.array([[[0.0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60], [0, 0, 10, 10], [70, 70, 80, 80]]], np.float32)
    scores = np.array([[0.8, 0.8, 0.6, 0.8, 0.1]], np.float32)
    classes = np.array([[0, 0, 1, 1, 0]], np.int32)
    got = tnms.nms(_t(boxes), _t(scores), _t(classes), 0.5, 0.45, 5)
    want = jnms.nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), jnp.asarray(classes[0]), 0.5, 0.45, 5)
    _assert_detections_equal(got, [want])
    assert got.anchor_idx[0].tolist() == [0, -1, 3, 2, -1]


@pytest.mark.parametrize("task", ["detect", "obb", "segment", "pose"])
def test_topk_then_suppress_equals_full_decode_then_nms(task):
    """The detector's fast path (top-K before the per-anchor decode, then
    `suppress`) gives the Detections of the general path (`decode_predictions`
    -> `best_class` -> `nms`), and its extras are the full extras at the kept
    anchors."""
    _, to = _both(_head_outs(task, 5))
    k, conf_thr, iou_thr = 30, 0.3, 0.45
    boxes, scores, classes, idx, extras = tyolo.decode_topk(to, SIZE, k, task=task)
    fast = tnms.suppress(boxes, scores, classes, idx, scores >= conf_thr, iou_thr)
    fb, fs, fe = tyolo.decode_predictions(to, SIZE, task=task)
    conf, cls = tnms.best_class(fs)
    full = tnms.nms(fb, conf, cls, conf_thr, iou_thr, k)
    for field in tnms.Detections._fields:
        _cmp(getattr(fast, field), getattr(full, field).numpy(), 1e-5)
    if extras is not None:
        for i in range(2):
            kept = fast.valid[i]
            _cmp(extras[i][kept], fe[i][fast.anchor_idx[i][kept].long()].numpy(), 1e-6)
