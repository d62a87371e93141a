"""Labeling session: polygon annotation with resume, multi-format output and
detector-assisted auto-labeling; the counterpart of the JAX package's
``data/labeler.py``.

A headless session object (the web UI in `serve/labeler_app.py` drives it;
so can scripts):

  * per-image polygon store with class labels; polygon edit/move/rotate/copy
    (rotate +-5 degrees = the reference's n/b keys);
  * resume via a state file recording the current image index
    (``current_state.txt``);
  * saving writes three label formats at once: OBB polygon, pose (cxcywh +
    keypoints + visibility) and object (cxcywh), plus a review CSV of pixel
    coordinates (``kiem_tra.csv``);
  * `auto_label`: run the port's `Detector` on the image and adopt its
    detections as polygons; `auto_label_segment`: a segment model's
    instance masks as polygons; `match_box`: a manual box adopts the
    best-IoU (> 0.3) detection;
  * navigation blocks while any polygon is unlabeled.

Images are read by `utils.images` (PNG or JPEG, PIL's pixels), so a
detector sees the frames the JAX package's detector sees.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np

from icp_slam_yolo_tpu_torch.data.csvutil import comma_table
from icp_slam_yolo_tpu_torch.data.labels import write_all_formats
from icp_slam_yolo_tpu_torch.utils.images import connected_regions, image_size, read_image, resize_bicubic, to_rgb

UNLABELED = "none"


@dataclasses.dataclass
class Polygon:
    points: list[list[float]]          # pixel coords
    label: str = UNLABELED

    def center(self):
        p = np.asarray(self.points)
        return p.mean(axis=0)

    def rotate(self, degrees: float) -> None:
        """Rotate about the centroid (the reference's n/b +-5 degree keys)."""
        c = self.center()
        rad = math.radians(degrees)
        cs, sn = math.cos(rad), math.sin(rad)
        p = np.asarray(self.points) - c
        self.points = (np.stack([cs * p[:, 0] - sn * p[:, 1], sn * p[:, 0] + cs * p[:, 1]], axis=1) + c).tolist()

    def move(self, dx: float, dy: float) -> None:
        self.points = [[x + dx, y + dy] for x, y in self.points]

    def bbox(self):
        p = np.asarray(self.points)
        return [p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max()]


def _iou(a, b) -> float:
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


class LabelSession:
    """One labeling run over an image directory."""

    def __init__(self, image_dir: str, out_dir: str, classes: list[str] | None = None,
                 state_file: str | None = None):
        from icp_slam_yolo_tpu_torch.io.yolo_data import find_pairs

        self.image_dir = image_dir
        self.out_dir = out_dir
        self.classes = classes or ["pallet"]
        self.images = [ip for ip, _ in find_pairs(image_dir)]
        if not self.images:
            raise FileNotFoundError(f"no images under {image_dir}")
        self.state_file = state_file or os.path.join(out_dir, "current_state.txt")
        self.annotations: dict[int, list[Polygon]] = {}
        self.index = 0
        self.clipboard: Polygon | None = None
        os.makedirs(out_dir, exist_ok=True)
        self._load_state()

    # --- resume (`current_state.txt`) ------------------------------------------
    def _load_state(self) -> None:
        if os.path.exists(self.state_file):
            try:
                data = json.loads(open(self.state_file).read())
                self.index = int(data.get("index", 0)) % len(self.images)
                for k, polys in data.get("annotations", {}).items():
                    self.annotations[int(k)] = [Polygon(**p) for p in polys]
            except (ValueError, json.JSONDecodeError):
                self.index = 0

    def save_state(self) -> None:
        data = {
            "index": self.index,
            "annotations": {
                str(k): [dataclasses.asdict(p) for p in v] for k, v in self.annotations.items()
            },
        }
        with open(self.state_file, "w") as f:
            json.dump(data, f)

    # --- polygon ops -------------------------------------------------------------
    @property
    def current(self) -> list[Polygon]:
        return self.annotations.setdefault(self.index, [])

    def add_polygon(self, points, label: str = UNLABELED) -> int:
        self.current.append(Polygon([list(map(float, p)) for p in points], label))
        return len(self.current) - 1

    def delete_polygon(self, i: int) -> None:
        del self.current[i]

    def set_label(self, i: int, label: str) -> None:
        self.current[i].label = label

    def copy_polygon(self, i: int) -> None:
        self.clipboard = Polygon([list(p) for p in self.current[i].points], self.current[i].label)

    def paste_polygon(self) -> int | None:
        if self.clipboard is None:
            return None
        return self.add_polygon(self.clipboard.points, self.clipboard.label)

    # --- navigation (blocked while any polygon is unlabeled) ---------------------
    def can_navigate(self) -> bool:
        return all(p.label != UNLABELED for p in self.current)

    def next_image(self) -> bool:
        if not self.can_navigate():
            return False
        self.index = (self.index + 1) % len(self.images)
        self.save_state()
        return True

    def prev_image(self) -> bool:
        if not self.can_navigate():
            return False
        self.index = (self.index - 1) % len(self.images)
        self.save_state()
        return True

    # --- auto labeling -------------------------------------------------------------
    def _rgb(self) -> np.ndarray:
        """The current image as RGB uint8 (PIL's ``convert("RGB")``)."""
        return to_rgb(read_image(self.images[self.index]))

    def auto_label(self, detector, default_label: str | None = None) -> int:
        """Run the detector on the current image; adopt its detections as
        rectangle polygons ('s' key semantics)."""
        out = detector(self._rgb())
        n = 0
        label = default_label or self.classes[0]
        for (x1, y1, x2, y2) in np.asarray(out["boxes"]).reshape(-1, 4):
            self.add_polygon([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], label)
            n += 1
        return n

    def auto_label_segment(self, seg_model_apply, img_size: int, default_label: str | None = None,
                           conf_threshold: float = 0.5, max_instances: int = 8, device=None) -> int:
        """Segmentation-assisted auto-label: run a segment-task model, turn
        its instance masks into polygons scaled to image pixels, and adopt
        them as labeled polygons.

        ``seg_model_apply(images) -> (outs, protos)`` is a forward of a port
        `YOLO(task="segment")` in inference mode (NHWC float input on
        ``device``, the card unless ``"cpu"`` is asked for); the image is
        resized to ``img_size`` square by PIL's bicubic filter."""
        import torch

        from icp_slam_yolo_tpu_torch.device import resolve_device
        from icp_slam_yolo_tpu_torch.models.segment import assemble_masks, mask_to_polygon
        from icp_slam_yolo_tpu_torch.models.yolo import decode_predictions
        from icp_slam_yolo_tpu_torch.ops.nms import best_class, nms

        img = self._rgb()
        h, w = img.shape[:2]
        arr = resize_bicubic(img, img_size, img_size).astype(np.float32) / 255.0
        with torch.no_grad():
            outs, protos = seg_model_apply(torch.from_numpy(arr[None]).to(resolve_device(device)))
            boxes, scores, coefs = decode_predictions(outs, img_size, task="segment")
            # NMS so overlapping anchors yield one instance each
            conf, cls_idx = best_class(scores[0])
            dets = nms(boxes[0][None], conf[None], cls_idx[None], conf_threshold, 0.45, max_instances)
            keep_mask = dets.valid[0].cpu().numpy()
            if not keep_mask.any():
                return 0
            # recover the surviving anchors' coefficients by box identity
            det_boxes = dets.boxes[0].float().cpu().numpy()[keep_mask]
            all_boxes = boxes[0].float().cpu().numpy()
            anchor_ids = [int(np.argmin(np.abs(all_boxes - b).sum(1))) for b in det_boxes]
            masks = assemble_masks(protos[0], coefs[0][torch.as_tensor(anchor_ids, device=coefs.device)],
                                   torch.from_numpy(det_boxes).to(coefs.device), img_size).cpu().numpy()
        sp = masks.shape[1]
        label = default_label or self.classes[0]
        n = 0
        for mask in masks:
            poly = mask_to_polygon(mask)
            if len(poly) < 3:
                continue
            scaled = poly / sp * np.array([w, h])
            self.add_polygon(scaled.tolist(), label)
            n += 1
        return n

    def match_box(self, bbox, detector, iou_threshold: float = 0.3) -> int | None:
        """Manual bbox -> adopt the best-matching detection (IoU > 0.3,
        'm' key semantics)."""
        out = detector(self._rgb())
        best, best_iou = None, iou_threshold
        for box in np.asarray(out["boxes"]).reshape(-1, 4):
            i = _iou(bbox, box)
            if i > best_iou:
                best, best_iou = box, i
        if best is None:
            return None
        x1, y1, x2, y2 = best
        return self.add_polygon([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], self.classes[0])

    # --- mask paintbrush ---------------------------------------------------------------
    def new_mask(self, width: int, height: int) -> np.ndarray:
        """Start a paint mask for the current image (brush-based labeling)."""
        self._mask = np.zeros((height, width), bool)
        return self._mask

    def paint(self, x: int, y: int, brush_size: int = 10, shape: str = "square",
              erase: bool = False) -> None:
        """Paint/erase with a sized square or circle brush (erase = the
        right-button drag)."""
        m = self._mask
        h, w = m.shape
        r = brush_size // 2
        y0, y1 = max(0, y - r), min(h, y + r + 1)
        x0, x1 = max(0, x - r), min(w, x + r + 1)
        if shape == "circle":
            yy, xx = np.mgrid[y0:y1, x0:x1]
            sel = (yy - y) ** 2 + (xx - x) ** 2 <= r * r
            m[y0:y1, x0:x1][sel] = not erase
        else:
            m[y0:y1, x0:x1] = not erase

    def mask_to_polygons(self, label: str | None = None, min_area: int = 20) -> int:
        """Convert painted regions (4-connected) to polygons; returns the
        polygons added."""
        from icp_slam_yolo_tpu_torch.models.segment import mask_to_polygon

        added = 0
        for labels_img, n, ys, _ in connected_regions(self._mask):
            if len(ys) < min_area:
                continue
            poly = mask_to_polygon((labels_img == n).astype(float), max_points=24)
            if len(poly) >= 3:
                self.add_polygon(poly.tolist(), label or UNLABELED)
                added += 1
        return added

    # --- output (three formats at once + review CSV) ------------------------------------
    def save_labels(self) -> int:
        path = self.images[self.index]
        stem = os.path.splitext(os.path.basename(path))[0]
        w, h = image_size(path)
        dirs = {
            "obb": os.path.join(self.out_dir, "output"),
            "pose": os.path.join(self.out_dir, "output_pose"),
            "object": os.path.join(self.out_dir, "output_oject"),  # sic: the reference's directory name
        }
        # overwrite per image
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
            fp = os.path.join(d, stem + ".txt")
            if os.path.exists(fp):
                os.remove(fp)
        review = comma_table(os.path.join(self.out_dir, "kiem_tra.csv"))
        n = 0
        for poly in self.current:
            if poly.label == UNLABELED:
                continue
            cls = self.classes.index(poly.label) if poly.label in self.classes else 0
            norm = [(x / w, y / h) for x, y in poly.points]
            write_all_formats(dirs, stem, cls, norm)
            review.append([stem, poly.label] + [f"{v:.1f}" for xy in poly.points for v in xy])
            n += 1
        self.save_state()
        return n
