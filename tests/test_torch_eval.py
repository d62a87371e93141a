"""The port's evaluation (`models/eval.py`) against the JAX package's: the
metrics on seeded predictions, then the four evaluators on a small PNG set
with the repository's checkpoints at a 64 px input, float32 on both sides,
the unfused convs.  The frames are `chip_smoke.pallet_image`s (120 x 160);
the checkpoints were not trained on such frames (they score them near 1e-5,
with boxes reaching past the frame), so each set's labels are made from the
JAX detector's own detections, jittered, and the detectors run at a
threshold of 1e-6: the metrics then come out between 0 and 1, not at 0.

Tolerances: `evaluate_detections` equal (the same numpy code on the same
inputs); the evaluators' metrics within 2e-3 absolute (the detectors' boxes
and scores agree as `test_torch_detect.py` holds them, 0.02 px and 1e-4,
which can move a candidate across an IoU threshold only at a tie)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from PIL import Image

import chip_smoke
import icp_slam_yolo_tpu_torch as port
from icp_slam_yolo_tpu.io import yolo_data as jdata
from icp_slam_yolo_tpu.models import detect as jdetect
from icp_slam_yolo_tpu.models import eval as jeval
from icp_slam_yolo_tpu_torch.io import yolo_data as tdata
from icp_slam_yolo_tpu_torch.models import eval as teval

torch.set_num_threads(2)
SIZE = 64
CONF = 1e-6
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints", "pallet_{}_640.msgpack")


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Six PNG frames in ``images/``; returns the directory's parent."""
    from icp_slam_yolo_tpu_torch.utils.images import encode_png

    root = tmp_path_factory.mktemp("val")
    (root / "images").mkdir()
    rng = np.random.default_rng(6)
    for i in range(6):
        img, _ = chip_smoke.pallet_image(rng, 120, 160)
        (root / "images" / f"{i:02d}.png").write_bytes(encode_png(img))
    return root


def _labelled(root, task, tmp_path):
    """``tmp_path/{images,labels}``: the frames and labels from the JAX
    detector's best detections (two a frame at most, each side jittered by
    8 % of the box's size): boxes (detect), the box as a polygon turned by the detected
    angle (obb) or as a rectangle (segment), the box and the keypoints
    (pose)."""
    jdet = jdetect.detector_from_checkpoint(CKPT.format(task), conf_threshold=CONF, compute_dtype=jnp.float32,
                                            img_size=SIZE, pallas_convs=False)
    rng = np.random.default_rng(len(task))
    (tmp_path / "labels").mkdir()
    os.symlink(root / "images", tmp_path / "images")
    for path in sorted((root / "images").iterdir()):
        out = jdet(np.asarray(Image.open(path).convert("RGB")))
        rows = []
        for k in range(min(2, len(out["boxes"]))):
            b = out["boxes"][k]
            x0, y0, x1, y1 = b + rng.normal(0, 0.08, 4) * np.repeat(b[2:] - b[:2], 2)
            cx, cy, w, h = (x0 + x1) / 2, (y0 + y1) / 2, max(x1 - x0, 2.0), max(y1 - y0, 2.0)
            corners = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
            if task == "obb":
                a = float(out["angles"][k])
                corners = corners @ np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
            norm = (np.array([cx, cy]) + corners) / np.array([160.0, 120.0])
            box = f"{cx / 160:.6f} {cy / 120:.6f} {w / 160:.6f} {h / 120:.6f}"
            if task == "detect":
                rows.append(f"0 {box}")
            elif task == "pose":
                kp = out["keypoints"][k][:, :2] + rng.normal(0, 2.0, (4, 2))
                rows.append(f"0 {box} " + " ".join(f"{x / 160:.6f} {y / 120:.6f} 2" for x, y in kp))
            else:
                rows.append("0 " + " ".join(f"{v:.6f}" for v in norm.reshape(-1)))
        (tmp_path / "labels" / (path.stem + ".txt")).write_text("\n".join(rows) + "\n")
    return tmp_path


def _pair(task, conf):
    j = jdetect.detector_from_checkpoint(CKPT.format(task), conf_threshold=conf, compute_dtype=jnp.float32,
                                         img_size=SIZE, pallas_convs=False)
    t = port.detector_from_checkpoint(CKPT.format(task), conf_threshold=conf, compute_dtype=torch.float32,
                                      img_size=SIZE, device="cpu")
    return j, t


def _close(got: dict, want: dict, atol=2e-3):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if w is None or g is None:
            assert g is None and w is None, k
        else:
            assert abs(g - w) <= atol, (k, g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_detections_equals_jax(seed):
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for i in range(8):
        n_gt = int(rng.integers(0, 4))
        xy = rng.uniform(0, 100, (n_gt, 2))
        g = np.concatenate([xy, xy + rng.uniform(10, 60, (n_gt, 2))], 1)
        gts.append({"boxes": g, "classes": rng.integers(0, 3, n_gt)})
        n_p = int(rng.integers(0, 6))
        src = g[rng.integers(0, max(n_gt, 1), n_p)] if n_gt else rng.uniform(0, 100, (n_p, 4))
        p = src + rng.normal(0, 6, (n_p, 4))
        preds.append({"boxes": p, "scores": np.round(rng.random(n_p), 2), "classes": rng.integers(0, 3, n_p)})
    assert teval.evaluate_detections(preds, gts) == jeval.evaluate_detections(preds, gts)
    assert teval.evaluate_detections(preds, gts, [0.3, 0.6]) == jeval.evaluate_detections(preds, gts, [0.3, 0.6])
    assert teval.evaluate_detections([], []) == jeval.evaluate_detections([], [])
    d = np.array([-3.0, -1.6, 0.0, 1.6, 3.1])
    assert np.array_equal(teval.wrap_half_pi(d), jeval.wrap_half_pi(d))


def test_evaluate_detector_matches_jax(frames, tmp_path):
    root = _labelled(frames, "detect", tmp_path)
    j, t = _pair("detect", 0.5)
    want = jeval.evaluate_detector(j, str(root), SIZE, conf_threshold=CONF)
    got = teval.evaluate_detector(t, str(root), SIZE, conf_threshold=CONF)
    assert 0.0 < want["mAP50_95"] < 1.0
    _close(got, want)
    assert t.conf_threshold == 0.5  # restored after the sweep


def test_evaluate_obb_detector_matches_jax(frames, tmp_path):
    root = _labelled(frames, "obb", tmp_path)
    j, t = _pair("obb", CONF)
    want = jeval.evaluate_obb_detector(j, str(root))
    assert 0.0 < want["mAP50_95"] < 1.0  # the angle errors count scores >= 0.5: None on both sides here
    _close(teval.evaluate_obb_detector(t, str(root)), want)


def test_evaluate_pose_detector_matches_jax(frames, tmp_path):
    root = _labelled(frames, "pose", tmp_path)
    pairs = tdata.find_pairs(str(root / "images"), label_root=str(root / "labels"))
    assert pairs == jdata.find_pairs(str(root / "images"), label_root=str(root / "labels"))
    j, t = _pair("pose", CONF)
    got, want = teval.evaluate_pose_detector(t, pairs), jeval.evaluate_pose_detector(j, pairs)
    assert got["n_val"] == want["n_val"] == 6 and want["detection_recall"] == 1.0 and want["pck_0.1"] > 0
    _close(got, want, atol=2e-2)  # corner errors in frame pixels: 0.02 px boxes, keypoints alike


def test_evaluate_segment_checkpoint_matches_jax(frames, tmp_path):
    root = _labelled(frames, "segment", tmp_path)
    path = CKPT.format("segment")
    want = jeval.evaluate_segment_checkpoint(path, str(root), SIZE)
    got = teval.evaluate_segment_checkpoint(path, str(root), SIZE, device="cpu")
    assert got["n_val"] == want["n_val"] == 6 and want["mask_iou_mean"] > 0
    _close(got, want)
