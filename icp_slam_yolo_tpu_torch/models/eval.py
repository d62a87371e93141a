"""Detection evaluation: COCO-style AP at IoU thresholds, OBB angle error,
pose corner error and segment mask IoU; the counterpart of the JAX
package's ``models/eval.py``.

The metrics the reference reports from Ultralytics training (precision,
recall, mAP50, mAP50-95; the OBB run's angle error) for the port's
detectors.  Images are read by `utils.images.read_image` (JPEG to PIL's
pixels, PNG or ``.npy``).
"""

from __future__ import annotations

import numpy as np
import torch


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def average_precision(tp: np.ndarray, scores: np.ndarray, n_gt: int) -> float:
    """101-point interpolated AP from per-detection TP flags."""
    if n_gt == 0 or len(tp) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
    ap = 0.0
    for r in np.linspace(0, 1, 101):
        mask = recall >= r
        ap += precision[mask].max() if mask.any() else 0.0
    return ap / 101


def evaluate_detections(predictions: list[dict], ground_truths: list[dict], iou_thresholds=None):
    """Per-image dicts: predictions ``{boxes (N, 4), scores (N,), classes
    (N,)}``, ground truths ``{boxes (M, 4), classes (M,)}`` in one pixel
    space.  Returns precision and recall at IoU 0.5 (at the confidence of
    the best F1) and mAP50 / mAP50-95 (AP averaged over the classes present
    in the ground truth)."""
    iou_thresholds = iou_thresholds if iou_thresholds is not None else np.arange(0.5, 1.0, 0.05)
    classes = sorted({int(c) for gt in ground_truths for c in np.asarray(gt["classes"]).tolist()})
    if not classes:
        return {"precision": 0.0, "recall": 0.0, "mAP50": 0.0, "mAP50_95": 0.0}

    aps = np.zeros((len(classes), len(iou_thresholds)))
    p50 = r50 = 0.0
    for ci, cls in enumerate(classes):
        for ti, thr in enumerate(iou_thresholds):
            tps, scs, n_gt = [], [], 0
            for pred, gt in zip(predictions, ground_truths):
                gmask = np.asarray(gt["classes"]) == cls
                gboxes = np.asarray(gt["boxes"], float).reshape(-1, 4)[gmask]
                n_gt += len(gboxes)
                pmask = np.asarray(pred["classes"]) == cls
                pboxes = np.asarray(pred["boxes"], float).reshape(-1, 4)[pmask]
                pscores = np.asarray(pred["scores"], float)[pmask]
                order = np.argsort(-pscores)
                pboxes, pscores = pboxes[order], pscores[order]
                iou = _iou_matrix(pboxes, gboxes)
                taken = np.zeros(len(gboxes), bool)
                for i in range(len(pboxes)):
                    # greedy matching: the best untaken ground truth above the threshold
                    if len(gboxes):
                        row = np.where(taken, -1.0, iou[i])
                        j = int(np.argmax(row))
                        ok = row[j] >= thr
                    else:
                        ok = False
                    if ok:
                        taken[j] = True
                    tps.append(ok)
                    scs.append(pscores[i])
            tps_a, scs_a = np.asarray(tps, bool), np.asarray(scs)
            aps[ci, ti] = average_precision(tps_a, scs_a, n_gt)
            if ti == 0:
                # precision and recall at the best F1's confidence (Ultralytics'
                # P and R), not over the whole low-threshold list AP needs
                order = np.argsort(-scs_a)
                cum_tp = np.cumsum(tps_a[order])
                cum_fp = np.cumsum(~tps_a[order])
                prec = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
                rec = cum_tp / max(n_gt, 1)
                f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-9)
                k = int(np.argmax(f1)) if len(f1) else 0
                if len(f1):
                    p50 += float(prec[k])
                    r50 += float(rec[k])

    return {
        "precision": float(p50 / len(classes)),
        "recall": float(r50 / len(classes)),
        "mAP50": float(aps[:, 0].mean()),
        "mAP50_95": float(aps.mean()),
    }


def evaluate_detector(detector, dataset_root: str, img_size: int, max_images: int | None = None,
                      conf_threshold: float = 0.001):
    """Run a `Detector` over a YOLO-layout val set (`predict_batch` a
    letterboxed image at a time) and compute the metrics; AP needs the full
    sweep, so the threshold is ``conf_threshold`` for the run."""
    from icp_slam_yolo_tpu_torch.io.yolo_data import find_pairs, load_example

    old_conf = detector.conf_threshold
    detector.conf_threshold = conf_threshold
    preds, gts = [], []
    try:
        pairs = find_pairs(dataset_root)
        if max_images:
            pairs = pairs[:max_images]
        for ip, lp in pairs:
            img, cls, boxes, _ = load_example(ip, lp, img_size)
            dets = detector.predict_batch(img[None])
            valid = dets.valid[0].cpu().numpy()
            preds.append({"boxes": dets.boxes[0].float().cpu().numpy()[valid],
                          "scores": dets.scores[0].float().cpu().numpy()[valid],
                          "classes": dets.classes[0].cpu().numpy()[valid]})
            gts.append({"boxes": boxes, "classes": cls})
    finally:
        detector.conf_threshold = old_conf
    return evaluate_detections(preds, gts)


def wrap_half_pi(d: np.ndarray) -> np.ndarray:
    """Angle differences wrapped into (-pi/2, pi/2]: a rectangle's
    orientation is pi-periodic."""
    return np.arctan2(np.sin(2.0 * d), np.cos(2.0 * d)) / 2.0


def evaluate_obb_detector(detector, dataset_root: str, max_images: int | None = None):
    """An OBB detector's quality: detection AP, and the rotation error
    (degrees) of confident predictions (score >= 0.5) matched to labelled
    polygons at IoU >= 0.5.  Build the detector with a low
    ``conf_threshold`` (0.001): AP needs the full sweep."""
    from icp_slam_yolo_tpu_torch.io.yolo_data import find_pairs, parse_polygons, polygon_angle
    from icp_slam_yolo_tpu_torch.utils.images import read_image, to_rgb

    pairs = find_pairs(dataset_root)
    if max_images:
        pairs = pairs[:max_images]
    preds, gts, angle_errs = [], [], []
    for ip, lp in pairs:
        img = to_rgb(read_image(ip))
        h0, w0 = img.shape[:2]
        cls, polys = parse_polygons(lp)
        gt_boxes, gt_angles = [], []
        for poly in polys:
            px = poly * np.array([w0, h0])  # pixels: uniform for the angles
            lo, hi = px.min(0), px.max(0)
            gt_boxes.append([lo[0], lo[1], hi[0], hi[1]])
            gt_angles.append(polygon_angle(px))
        gt_boxes = np.array(gt_boxes, float).reshape(-1, 4)
        gt_angles = np.array(gt_angles, float)
        out = detector(img)
        preds.append(out)
        gts.append({"boxes": gt_boxes, "classes": cls})

        conf = out["scores"] >= 0.5
        pboxes = out["boxes"][conf]
        pangles = np.asarray(out["angles"]).reshape(-1)[conf]
        if len(pboxes) and len(gt_boxes):
            iou = _iou_matrix(pboxes, gt_boxes)
            taken = np.zeros(len(gt_boxes), bool)
            for i in np.argsort(-out["scores"][conf]):
                row = np.where(taken, -1.0, iou[i])
                j = int(np.argmax(row))
                if row[j] >= 0.5:
                    taken[j] = True
                    angle_errs.append(abs(wrap_half_pi(pangles[i] - gt_angles[j])))

    metrics = evaluate_detections(preds, gts)
    errs = np.degrees(np.array(angle_errs)) if angle_errs else None
    metrics.update(
        angle_error_mean_deg=round(float(errs.mean()), 2) if errs is not None else None,
        angle_error_p90_deg=round(float(np.percentile(errs, 90)), 2) if errs is not None else None,
        val_images=len(pairs),
    )
    return metrics


def evaluate_pose_detector(detector, pairs) -> dict:
    """A pose detector's corner quality on ``(image, label)`` pairs: mean
    and p90 corner error in the original frame's pixels, PCK@0.1 (a corner
    within 10 % of the ground-truth box's diagonal), mean OKS and the share
    of labelled images with a detection."""
    from icp_slam_yolo_tpu_torch.io.yolo_data import parse_pose_label
    from icp_slam_yolo_tpu_torch.utils.images import read_image, to_rgb

    errs, oks_all, hits, n_det, n_img = [], [], 0, 0, 0
    for ip, lp in pairs:
        cls, boxes, kpts = parse_pose_label(lp)
        if not len(cls):
            continue
        n_img += 1
        img = to_rgb(read_image(ip))
        h0, w0 = img.shape[:2]
        out = detector(img)
        if not len(out["boxes"]):
            continue
        n_det += 1
        best = int(np.argmax(out["scores"]))
        pred = out["keypoints"][best]  # (K, 3) in the frame's pixels
        gt = kpts[0].copy()
        gt[:, 0] *= w0
        gt[:, 1] *= h0
        vis = gt[:, 2] > 0
        d = np.linalg.norm(pred[:, :2] - gt[:, :2], axis=1)[vis]
        bw = boxes[0, 2] * w0
        bh = boxes[0, 3] * h0
        diag = float(np.hypot(bw, bh))
        errs.extend(d.tolist())
        hits += int(np.sum(d <= 0.1 * diag))
        area = max(bw * bh, 1.0)
        sigma = 1.0 / gt.shape[0]
        oks = np.mean(np.exp(-(d ** 2) / (2 * area * (2 * sigma) ** 2)))
        oks_all.append(float(oks))

    errs = np.asarray(errs)
    return {
        "n_val": n_img,
        "detection_recall": n_det / max(n_img, 1),
        "corner_err_mean_px": float(errs.mean()) if len(errs) else None,
        "corner_err_p90_px": float(np.percentile(errs, 90)) if len(errs) else None,
        "pck_0.1": hits / max(len(errs), 1),
        "oks_mean": float(np.mean(oks_all)) if oks_all else None,
    }


def evaluate_segment_checkpoint(ckpt_path: str, dataset_root: str, img_size: int, max_images: int | None = 60,
                                device=None) -> dict:
    """A segment checkpoint's mask IoU: the best detection's assembled mask
    against the first labelled polygon, rasterised at the proto resolution
    (``img_size // 4``); the unfolded float32 model.  ``device=None`` means
    the card."""
    from icp_slam_yolo_tpu_torch.convert import detector_params_from_numpy
    from icp_slam_yolo_tpu_torch.device import resolve_device
    from icp_slam_yolo_tpu_torch.io.checkpoint import load_checkpoint
    from icp_slam_yolo_tpu_torch.io.yolo_data import (
        find_pairs, load_example, map_polygon, parse_polygons, rasterize_polygon,
    )
    from icp_slam_yolo_tpu_torch.models.segment import assemble_masks
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO, decode_predictions

    dev = resolve_device(device)
    payload, batch_stats, meta = load_checkpoint(ckpt_path)
    model = YOLO(num_classes=meta.get("num_classes", 1), variant=meta.get("variant", "n"),
                 family=meta.get("family", "v8"), task="segment")
    model.load_state_dict(detector_params_from_numpy(payload["params"], batch_stats or {}, model))
    model.to(dev)
    sp = img_size // 4
    ious = []
    pairs = find_pairs(dataset_root)
    if max_images:
        pairs = pairs[:max_images]
    for ip, lp in pairs:
        img, cls, boxes, (_, _, _, w0, h0) = load_example(ip, lp, img_size)
        with torch.no_grad():
            outs, protos = model(torch.from_numpy(img[None]).to(dev))
            b, s, coefs = decode_predictions(outs, img_size)
            top = int(torch.argmax(s[0, :, 0]))
            mask = assemble_masks(protos[0], coefs[0, top:top + 1], b[0, top:top + 1], img_size)[0].cpu().numpy()
        _, polys = parse_polygons(lp)
        if not polys:
            continue
        gt = rasterize_polygon(map_polygon(polys[0], w0, h0, img_size) * (sp / img_size), sp)
        pred = mask >= 0.5
        inter = float(np.logical_and(pred, gt > 0).sum())
        union = float(np.logical_or(pred, gt > 0).sum())
        if union > 0:
            ious.append(inter / union)
    ious = np.array(ious)
    return {
        "mask_iou_mean": float(ious.mean()) if len(ious) else None,
        "mask_iou_p10": float(np.percentile(ious, 10)) if len(ious) else None,
        "n_val": int(len(ious)),
    }
