"""`Detector` of the port against the JAX package's: letterbox, `__call__`,
`detect_pair`, `predict_batch`, the four tasks, the real checkpoints.

float32 on both sides.  Boxes agree to 0.02 px in the frame's pixels and
scores to 1e-4 (head logits differ by ~5e-5 between the frameworks, the DFL
softmax and the letterbox unmap scale that by a few); the candidates, their
classes and the survivors of NMS must be the same."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_slam_yolo_tpu_torch as port
from icp_slam_yolo_tpu.io import yolo_data as jdata
from icp_slam_yolo_tpu.models import detect as jdetect
from icp_slam_yolo_tpu_torch.io.checkpoint import load_checkpoint
from icp_slam_yolo_tpu_torch.models import detect as tdetect
from icp_slam_yolo_tpu_torch.models import yolo as tyolo
from icp_slam_yolo_tpu_torch.ops import pallas
from test_torch_yolo import seeded_tree

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
V8_CHECKPOINTS = ["pallet_detect_640", "pallet_obb_640", "pallet_obb_1024", "pallet_pose_640",
                  "pallet_segment_320", "pallet_segment_640"]
V11_V12_CHECKPOINTS = ["pallet_detect_v12_640", "pallet_obb_v11_640"]


def _frame(seed, h=480, w=640):
    return np.random.default_rng(seed).uniform(0, 255, (h, w, 3)).astype(np.uint8)


def _pair(task, seed, pallas_convs, **kw):
    """A JAX detector and the port's with the same seeded weights (an
    unfolded tree: both fold at load)."""
    params, stats = seeded_tree(task, seed, num_classes=1)
    tree = {"params": params, "batch_stats": stats}
    common = dict(num_classes=1, task=task, img_size=SIZE, conf_threshold=0.001, params=tree, **kw)
    jdet = jdetect.Detector(compute_dtype=jnp.float32, pallas_convs=False, **common)
    tdet = tdetect.Detector(compute_dtype=torch.float32, pallas_convs=pallas_convs, device="cpu", **common)
    return jdet, tdet


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.02)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)
    np.testing.assert_array_equal(got["classes"], want["classes"])
    for key in set(got) - {"boxes", "scores", "classes"}:
        assert got[key].shape == np.asarray(want[key]).shape
        np.testing.assert_allclose(got[key], want[key], atol=0.02 if key == "keypoints" else 2e-3)


@pytest.mark.parametrize("w0,h0,size", [(640, 480, 640), (480, 640, 64), (1000, 333, 320), (64, 64, 64)])
def test_letterbox_transform_equals_jax(w0, h0, size):
    assert tdetect.letterbox_transform(w0, h0, size) == jdata.letterbox_transform(w0, h0, size)
    assert tdetect.LETTERBOX_FILL == jdata.LETTERBOX_FILL


@pytest.mark.parametrize("shape,dtype", [((480, 640), np.uint8), ((50, 120), np.float32), ((64, 64), np.uint8)])
def test_preprocess_equals_jax(shape, dtype):
    jdet, tdet = _pair("detect", 20, False)
    frame = _frame(0, *shape)
    frame = frame if dtype == np.uint8 else frame.astype(np.float32) / 255.0
    (jb, jt), (tb, tt) = jdet.preprocess(frame), tdet.preprocess(frame)
    np.testing.assert_array_equal(tb, jb)
    assert tt == jt


@pytest.mark.parametrize("pallas_convs", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("task", ["detect", "obb", "segment", "pose"])
def test_call_matches_jax(task, pallas_convs):
    jdet, tdet = _pair(task, 21, pallas_convs)
    frame = _frame(1)
    _assert_same(tdet(frame), jdet(frame))


def test_detect_pair_matches_jax_and_two_single_calls():
    jdet, tdet = _pair("detect", 22, True)
    f1, f2 = _frame(2), _frame(3)
    got, want = tdet.detect_pair(f1, f2), jdet.detect_pair(f1, f2)
    for g, w, single in zip(got, want, (tdet(f1), tdet(f2))):
        _assert_same(g, w)
        # a library conv may sum in another order at batch 2 than at batch 1: last-digit differences
        np.testing.assert_allclose(g["boxes"], single["boxes"], atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(g["scores"], single["scores"], atol=1e-5)
        np.testing.assert_array_equal(g["classes"], single["classes"])


def test_predict_batch_matches_jax_and_reads_thresholds_each_call():
    jdet, tdet = _pair("detect", 23, True)
    images = np.random.default_rng(4).random((3, SIZE, SIZE, 3)).astype(np.float32)
    got, want = tdet.predict_batch(images), jdet.predict_batch(jnp.asarray(images))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.anchor_idx.numpy(), np.asarray(want.anchor_idx))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=0.01)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-4)
    tdet.conf_threshold = 0.9
    assert int(tdet.predict_batch(images).valid.sum()) < int(got.valid.sum())


def test_defaults_and_device_rule():
    """ROADMAP fault d: `Detector` defaults to the kernels,
    `detector_from_checkpoint` to `F.conv2d`, as in the JAX package; the
    kernels need folded weights; no card and no `device="cpu"` raises."""
    path = os.path.join(REPO, "checkpoints", "pallet_detect_640.msgpack")
    assert tdetect.Detector(img_size=SIZE, device="cpu").model.fused is True
    assert tdetect.Detector(img_size=SIZE, device="cpu", fold_bn=False).model.fused is False
    assert port.detector_from_checkpoint(path, device="cpu").model.fused is False
    assert port.detector_from_checkpoint(path, device="cpu", pallas_convs=True).model.fused is True
    assert port.Detector is tdetect.Detector
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.Detector(img_size=SIZE)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.detector_from_checkpoint(path)


@pytest.mark.parametrize("name", V8_CHECKPOINTS + V11_V12_CHECKPOINTS)
def test_real_checkpoint_at_64px_matches_jax(name):
    """The trained weights through both packages at a 64 px input (a 640 px
    JAX forward on the CPU is slow): fused port path against the JAX
    package's unfused path, float32.  The v11 and v12 checkpoints load by
    their sidecars' ``family`` and ``task``."""
    path = os.path.join(REPO, "checkpoints", name + ".msgpack")
    kw = dict(conf_threshold=0.0, img_size=SIZE)
    jdet = jdetect.detector_from_checkpoint(path, compute_dtype=jnp.float32, **kw)
    tdet = port.detector_from_checkpoint(path, compute_dtype=torch.float32, pallas_convs=True, device="cpu", **kw)
    assert tdet.task == jdet.task and tdet.model.task == jdet.task
    assert tdet.model.family == jdet.model.family
    before = dict(pallas.LAUNCHES)
    _assert_same(tdet(_frame(5)), jdet(_frame(5)))
    assert pallas.LAUNCHES == before


@pytest.mark.parametrize("name", V8_CHECKPOINTS)
def test_shortcut_flag_from_the_module_agrees_with_the_name_rule(name):
    """ROADMAP fault e: the JAX package infers a C2f's shortcut from the
    ``c2f*`` name prefix; the port reads it from the module.  They agree on
    every v8 checkpoint, and every single-bottleneck C2f of the checkpoint is
    one the whole-block kernel takes."""
    path = os.path.join(REPO, "checkpoints", name + ".msgpack")
    payload, _, _ = load_checkpoint(path)
    by_name = {n for n, sub in payload["params"].items()
               if isinstance(sub, dict) and "Bottleneck_0" in sub and "Bottleneck_1" not in sub}
    det = port.detector_from_checkpoint(path, pallas_convs=True, device="cpu")
    whole = {n: m for n, m in det.model.named_children() if isinstance(m, tyolo.C2f) and m.whole_block_kernel()}
    assert set(whole) == by_name and len(whole) == 6
    for n, m in whole.items():
        assert m.Bottleneck_0.shortcut == m.shortcut == n.startswith("c2f")
    assert det.model.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("name", V11_V12_CHECKPOINTS)
def test_shortcut_flag_from_the_module_agrees_with_the_name_rule_on_v11_v12(name):
    """ROADMAP fault e on the v11 and v12 checkpoints: they have no C2f.  The
    JAX package's name rule would see a C2f in every single-bottleneck C3k2
    scope and give it no shortcut (not ``c2f*``), while the module's
    bottleneck has one; neither package gives such a block to the
    whole-block kernel (JAX's interceptor matches only a C2f), and the
    port's fused model has no block the kernel would take."""
    path = os.path.join(REPO, "checkpoints", name + ".msgpack")
    payload, _, _ = load_checkpoint(path)
    by_name = {n for n, sub in payload["params"].items()
               if isinstance(sub, dict) and "Bottleneck_0" in sub and "Bottleneck_1" not in sub}
    det = port.detector_from_checkpoint(path, pallas_convs=True, device="cpu")
    assert not any(isinstance(m, tyolo.C2f) for m in det.model.modules())
    assert by_name and all(isinstance(det.model.get_submodule(n), tyolo.C3k2) for n in by_name)
    for n in by_name:
        assert det.model.get_submodule(n).Bottleneck_0.shortcut and not n.startswith("c2f")
    assert det.model.compute_dtype == torch.bfloat16 and det.model.fused


def test_port_and_chip_smoke_import_no_jax_flax_or_jax_package():
    code = ("import sys, icp_slam_yolo_tpu_torch, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'icp_slam_yolo_tpu', 'msgpack')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "icp_slam_yolo_tpu_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith((".py", ".cu", ".cuh"))]
    for f in files:
        src = open(f).read()
        for word in ("import jax", "from jax", "import flax", "from flax", "import msgpack"):
            assert word not in src, (f, word)
        assert "icp_slam_yolo_tpu." not in src.replace("icp_slam_yolo_tpu_torch", "") or f.endswith("chip_smoke.py"), f
        if "csrc" in f:
            for word in ("cudnn", "cublas", "cutlass"):
                assert word not in src.lower(), (f, word)
