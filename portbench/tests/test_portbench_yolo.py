"""The plain yolov8n: its operation count, and its logits and detections
against the program's unfused float32 forward from the same state dict."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import judge
from portbench.entries.detect import as_lists, build_detector, read_detections
from portbench.frames import frame_pool
from portbench.reference import yolo
from portbench.spec import load_json
from portbench.weights import ultralytics_state

CFG = load_json("configs", "yolov8n-pallet")


@pytest.mark.parametrize("size", [64, 640])
def test_operation_count(size):
    sd = ultralytics_state(CFG, 1, "cpu")
    model = yolo.Model(CFG, sd)
    with FlopCounterMode(display=False) as fc:
        model.forward(torch.zeros(1, 3, size, size))
    assert fc.get_total_flops() == yolo.conv_flops(CFG, size)
    if size == 640:
        assert yolo.conv_flops(CFG, size) == 8081664000


def test_state_layout_is_ultralytics():
    keys = dict(yolo.state_layout(CFG))
    assert keys["model.0.conv.weight"] == (16, 3, 3, 3)
    assert keys["model.4.m.1.cv2.conv.weight"] == (32, 32, 3, 3)
    assert keys["model.22.cv3.2.2.bias"] == (1,)
    assert sum(torch.Size(s).numel() for s in keys.values()) == 3021427


@pytest.mark.parametrize("size", [64, 128])
def test_logits_and_detections_equal_the_program(size):
    cfg = dict(CFG, img_size=size, compute_dtype="float32", fused_convs=False, fold_bn=False)
    frames = frame_pool({"pool": 1, "batch": 2, "aspect": 0.75}, size, 11, "cpu")[0]
    sd = ultralytics_state(cfg, 2**31 + 5, "cpu", frames)
    det = build_detector(cfg, sd, "cpu")
    caught = []
    det.model.head.register_forward_hook(lambda m, i, o: caught.append(o))
    dets = as_lists(read_detections(det.predict_batch(frames)))
    levels = yolo.Model(cfg, sd).forward(frames.permute(0, 3, 1, 2))
    ours = [(b.permute(0, 3, 1, 2), c.permute(0, 3, 1, 2)) for b, c in caught[0]]
    assert judge.head_gap(ours, levels) < 1e-6
    boxes, conf, label = yolo.decode(levels, size, cfg["reg_max"])
    ref = yolo.detections(boxes, conf, label, cfg)
    bad, total = judge.detection_mismatch(dets, conf, ref, cfg["conf_threshold"])
    assert total > 0 and bad == 0
    for d, r in zip(dets, ref):
        assert (d["anchors"] == r["anchors"]).all()
