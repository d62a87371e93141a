"""Host-facing detector: ``detect(frame) -> boxes``; the counterpart of the
JAX package's ``models/detect.py``.

Per frame: letterbox on the host, then on the device the conv forward, the
top-K decode and NMS, then the unmap to the frame's pixels on the host.

Which conv path runs is the caller's choice and is never taken silently.
The defaults are the JAX package's: ``Detector(pallas_convs=True)`` runs the
hand-written kernels (K5-K8), ``detector_from_checkpoint(pallas_convs=False)``
runs ``F.conv2d`` + ``F.silu`` unless the caller asks for the kernels.
``device=None`` means the card and raises without one; ``device="cpu"`` runs
the kernels' plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from icp_slam_yolo_tpu_torch.convert import detector_params_from_numpy
from icp_slam_yolo_tpu_torch.device import resolve_device
from icp_slam_yolo_tpu_torch.models.yolo import BN_EPS, YOLO, decode_topk, fold_batchnorm
from icp_slam_yolo_tpu_torch.ops.nms import Detections, suppress
from icp_slam_yolo_tpu_torch.utils.profiling import span

LETTERBOX_FILL = 114.0 / 255.0  # Ultralytics pad gray


def letterbox_transform(w0: int, h0: int, size: int):
    """Ultralytics letterbox mapping: uniform scale + centred pad.  Returns
    ``(scale, pad_x, pad_y)`` such that an original pixel ``(x, y)`` lands at
    ``(x*scale + pad_x, y*scale + pad_y)`` in the ``size x size`` input."""
    scale = min(size / w0, size / h0)
    nw, nh = round(w0 * scale), round(h0 * scale)
    return scale, (size - nw) / 2.0, (size - nh) / 2.0


def detector_from_checkpoint(path: str, conf_threshold: float = 0.5, iou_threshold: float = 0.45,
                             compute_dtype=torch.bfloat16, img_size: int | None = None, fold_bn: bool = True,
                             pallas_convs: bool = False, device=None) -> "Detector":
    """Build a ``Detector`` from a checkpoint, honouring its metadata (task,
    family, variant, n_kpt, img_size, num_classes): a ``*.msgpack`` with its
    JSON sidecar, or an Ultralytics ``*.pt`` of a v8 or YOLO12 detect model
    (the family, and YOLO12's scale and class count, read from the weights;
    `io.torch_import`).  ``pallas_convs`` defaults to False here (the
    unfused ``F.conv2d`` path) and to True in ``Detector``, as in the JAX
    package."""
    payload, state = None, None
    if path.endswith(".pt"):
        from icp_slam_yolo_tpu_torch.io.torch_import import load_ultralytics_pt

        state, meta = load_ultralytics_pt(path)
        meta["task"] = "detect"
    else:
        from icp_slam_yolo_tpu_torch.io.checkpoint import load_checkpoint

        payload, _, meta = load_checkpoint(path)
    return Detector(
        num_classes=meta.get("num_classes", 1), variant=meta.get("variant", "n"), task=meta.get("task", "detect"),
        family=meta.get("family", "v8"), img_size=img_size or meta.get("img_size", 640), n_kpt=meta.get("n_kpt", 4),
        conf_threshold=conf_threshold, iou_threshold=iou_threshold, params=payload, compute_dtype=compute_dtype,
        fold_bn=fold_bn, pallas_convs=pallas_convs, device=device, state_dict=state,
    )


class Detector:
    """Owns the model; ``__call__`` runs frame -> detections.

    ``params``: a flax tree (``{"params": ..., "batch_stats": ...}`` of numpy
    arrays) or None for seeded random weights; or ``state_dict``: the state
    of the unfolded model (what `io.torch_import` gives).  ``fold_bn`` folds
    the BatchNorm affines into the convs at load (a PSABlock's or ABlock's
    bare BatchNorm stays); ``pallas_convs`` (needs ``fold_bn``) runs every conv
    site in the hand-written kernels, one launch per ConvBnAct or plain 1x1
    conv and one per v8 C2f block with a single bottleneck (grouped and
    depthwise convs and attention products stay library calls); False runs
    ``F.conv2d``.  ``family``: v8, v11, v12 or yolo12 (the published YOLO12,
    `models.yolo.YOLO`)."""

    def __init__(self, num_classes: int = 1, variant: str = "n", task: str = "detect", family: str = "v8",
                 img_size: int = 640, conf_threshold: float = 0.5, iou_threshold: float = 0.45,
                 max_detections: int = 100, params=None, seed: int = 0, compute_dtype=torch.bfloat16,
                 n_kpt: int = 4, fold_bn: bool = True, pallas_convs: bool = True, device=None, state_dict=None):
        self.device = resolve_device(device)
        self.img_size, self.task = img_size, task
        self.conf_threshold, self.iou_threshold, self.max_detections = conf_threshold, iou_threshold, max_detections
        self.pallas_convs = pallas_convs and fold_bn
        with torch.random.fork_rng(devices=[]):  # the seed draws the initial weights and nothing else
            torch.manual_seed(seed)
            self.model = YOLO(num_classes=num_classes, variant=variant, task=task, family=family, n_kpt=n_kpt,
                              compute_dtype=compute_dtype, fold_bn=fold_bn, fused=self.pallas_convs)
        if params is not None:
            tree = params["params"] if "params" in params else params
            stats = params.get("batch_stats", {})
            if fold_bn:
                tree, stats = fold_batchnorm(tree, stats)
            self.model.load_state_dict(detector_params_from_numpy(tree, stats, self.model))
        elif state_dict is not None:
            from icp_slam_yolo_tpu_torch.io.torch_import import fold_state_dict

            self.model.load_state_dict(fold_state_dict(state_dict, BN_EPS) if fold_bn else state_dict)
        self.model.to(self.device)

    @torch.no_grad()
    def _predict(self, images: torch.Tensor):
        """The device half of a batch, under the root span ``detect.batch``
        and its stages ``detect.forward``, ``detect.decode`` and
        ``detect.nms`` (`utils/profiling.span`)."""
        with span("detect.batch", images.device):
            with span("detect.forward"):
                outs = self.model(images)
            with span("detect.decode"):
                protos = None
                if self.task == "segment":
                    outs, protos = outs
                n_anchors = sum(o[0].shape[1] * o[0].shape[2] for o in outs)
                k = min(self.max_detections, n_anchors)
                boxes, scores, classes, idx, extras = decode_topk(outs, self.img_size, k, task=self.task)
            with span("detect.nms"):
                dets = suppress(boxes, scores, classes, idx, scores >= self.conf_threshold, self.iou_threshold)
        return dets, extras, protos

    def preprocess(self, frame: np.ndarray):
        """HWC uint8/float frame -> ``(1, S, S, 3)`` float32 [0, 1],
        letterboxed: aspect-preserving nearest-index resize and a centred
        114-gray pad.  Returns ``(batch, (scale, pad_x, pad_y))``; a
        model-space coordinate unmaps as ``(v - pad) / scale``."""
        img = np.asarray(frame)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        h, w = img.shape[:2]
        s = self.img_size
        scale, px, py = letterbox_transform(w, h, s)
        nw, nh = round(w * scale), round(h * scale)
        yi = ((np.arange(nh) + 0.5) / scale - 0.5).round().astype(np.int32).clip(0, h - 1)
        xi = ((np.arange(nw) + 0.5) / scale - 0.5).round().astype(np.int32).clip(0, w - 1)
        out = np.full((s, s, 3), LETTERBOX_FILL, np.float32)
        x0, y0 = int(round(px)), int(round(py))
        out[y0:y0 + nh, x0:x0 + nw] = img[yi][:, xi, :3]
        return out[None], (scale, px, py)

    def __call__(self, frame: np.ndarray) -> dict:
        """``detect(frame)``: dict with ``boxes (N, 4)`` xyxy in the frame's
        own pixels, ``scores``, ``classes`` (N valid detections) and the
        task's extras."""
        batch, (scale, px, py) = self.preprocess(frame)
        dets, extras, protos = self._predict(torch.from_numpy(batch).to(self.device))
        return self._postprocess_one(dets, extras, protos, 0, scale, px, py)

    def detect_pair(self, f1: np.ndarray, f2: np.ndarray) -> tuple[dict, dict]:
        """Stereo-pair detect: both eyes in one batch-2 forward.  The frames
        must share a shape."""
        b1, (s1, px1, py1) = self.preprocess(f1)
        b2, (s2, px2, py2) = self.preprocess(f2)
        dets, extras, protos = self._predict(torch.from_numpy(np.concatenate([b1, b2], 0)).to(self.device))
        return (self._postprocess_one(dets, extras, protos, 0, s1, px1, py1),
                self._postprocess_one(dets, extras, protos, 1, s2, px2, py2))

    def _postprocess_one(self, dets, extras, protos, i: int, scale, px, py) -> dict:
        valid = dets.valid[i].cpu().numpy()
        model_boxes = dets.boxes[i].float().cpu().numpy()[valid]
        boxes = (model_boxes - np.array([px, py, px, py], np.float32)) / np.float32(scale)
        out = {"boxes": boxes, "scores": dets.scores[i].cpu().numpy()[valid],
               "classes": dets.classes[i].cpu().numpy()[valid]}
        if extras is not None:
            gathered = extras[i].cpu().numpy()[valid]  # rows aligned with the candidates
            if self.task == "pose":
                gathered = gathered.copy()
                gathered[..., 0] = (gathered[..., 0] - px) / scale
                gathered[..., 1] = (gathered[..., 1] - py) / scale
                out["keypoints"] = gathered  # (N, K, 3) [x, y, vis] in the frame's pixels
            else:
                out["angles" if self.task == "obb" else "mask_coeffs"] = gathered
        if protos is not None:
            from icp_slam_yolo_tpu_torch.models.segment import assemble_masks

            dev = protos.device
            out["masks"] = assemble_masks(
                protos[i], torch.from_numpy(out["mask_coeffs"]).to(dev).reshape(-1, protos.shape[-1]),
                torch.from_numpy(model_boxes).to(dev).reshape(-1, 4), self.img_size,
            ).cpu().numpy()  # (N, Hp, Wp) probabilities at 1/4 model resolution
        return out

    def predict_batch(self, images) -> Detections:
        """Already-preprocessed ``(B, S, S, 3)`` batches (numpy or tensor) ->
        batched `Detections` on the detector's device.  The thresholds are
        read at each call."""
        dets, _, _ = self._predict(torch.as_tensor(images).to(self.device))
        return dets
