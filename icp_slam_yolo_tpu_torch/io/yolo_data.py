"""YOLO-layout datasets (images + normalised label txts); the counterpart of
the JAX package's ``io/yolo_data.py``.

The Ultralytics layout: ``images/*`` + ``labels/*.txt`` with rows ``class
cx cy w h`` normalised to [0, 1] (detect) or ``class x1 y1 ... xn yn``
polygons (obb, segment), or pose rows.  Batches are padded to ``max_gt``
boxes with a validity mask, for the static-shape loss.

Images are read by `utils.images.read_image` (PNG, JPEG to PIL's pixels,
or ``.npy``).  The two imaging operations the JAX package takes from PIL
are written to PIL's arithmetic, so the pixels are PIL's:
`utils.images.resize_bilinear` (``Image.resize(..., BILINEAR)`` on uint8)
and, here, `rasterize_polygon` (``ImageDraw.polygon(fill=1)``'s scanline
fill).
"""

from __future__ import annotations

import math
import os
import random

import numpy as np
import torch
import torch.nn.functional as F

from icp_slam_yolo_tpu_torch.models.detect import LETTERBOX_FILL, letterbox_transform
from icp_slam_yolo_tpu_torch.utils.images import read_image, resize_bilinear, to_rgb

# pose corner order is [tl, tr, br, bl] (`parse_pose_label`); a horizontal
# mirror exchanges the left and right corners
KPT_FLIP_PERM = np.array([1, 0, 3, 2])
_IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def find_pairs(root: str, label_root: str | None = None) -> list[tuple[str, str]]:
    """``(image, label)`` path pairs: ``root/{images,labels}``, or a flat
    directory with each txt beside its image, or (``label_root``) images in
    ``root`` and labels in ``label_root``."""
    def listed(img_dir, lbl_dir):
        out = []
        for name in sorted(os.listdir(img_dir)):
            stem, ext = os.path.splitext(name)
            if ext.lower() in _IMAGE_EXTS:
                out.append((os.path.join(img_dir, name), os.path.join(lbl_dir, stem + ".txt")))
        return out

    if label_root is not None:
        return listed(root, label_root)
    img_dir, lbl_dir = os.path.join(root, "images"), os.path.join(root, "labels")
    if os.path.isdir(img_dir) and os.path.isdir(lbl_dir):
        return listed(img_dir, lbl_dir)
    return listed(root, root)


def parse_label_file(path: str):
    """Rows of ``class cx cy w h`` (normalised) -> ``(classes, cxcywh)``;
    polygon rows (more than 5 columns) become their bounding box."""
    classes, boxes = [], []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                vals = line.split()
                if len(vals) < 5:
                    continue
                cls = int(float(vals[0]))
                coords = np.array([float(v) for v in vals[1:]])
                if len(coords) == 4:
                    cx, cy, w, h = coords
                else:  # polygon: x1 y1 x2 y2 ...
                    xs, ys = coords[0::2], coords[1::2]
                    cx = (xs.min() + xs.max()) / 2
                    cy = (ys.min() + ys.max()) / 2
                    w = xs.max() - xs.min()
                    h = ys.max() - ys.min()
                classes.append(cls)
                boxes.append([cx, cy, w, h])
    return np.array(classes, np.int32).reshape(-1), np.array(boxes, np.float64).reshape(-1, 4)


def parse_pose_label(path: str):
    """Pose rows ``class cx cy w h`` + K x ``(x y vis)`` (normalised) ->
    ``(classes (M,), cxcywh (M, 4), kpts (M, K, 3))``.  Four corners are put
    in the order [tl, tr, br, bl] (by y, then each pair by x); visibility
    becomes 0/1 and travels with its corner."""
    classes, boxes, kpts = [], [], []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                vals = line.split()
                if len(vals) < 8 or (len(vals) - 5) % 3 != 0:
                    continue
                classes.append(int(float(vals[0])))
                boxes.append([float(v) for v in vals[1:5]])
                k = np.array([float(v) for v in vals[5:]]).reshape(-1, 3)
                k[:, 2] = (k[:, 2] > 0).astype(np.float64)
                if k.shape[0] == 4:
                    order = np.argsort(k[:, 1], kind="stable")
                    top = order[:2][np.argsort(k[order[:2], 0], kind="stable")]
                    bot = order[2:][np.argsort(k[order[2:], 0], kind="stable")]
                    k = k[[top[0], top[1], bot[1], bot[0]]]  # tl, tr, br, bl
                kpts.append(k)
    n_kpt = kpts[0].shape[0] if kpts else 4
    return (np.array(classes, np.int32).reshape(-1), np.array(boxes, np.float64).reshape(-1, 4),
            np.array(kpts, np.float64).reshape(-1, n_kpt, 3))


def parse_polygons(path: str):
    """Polygon label rows -> ``(classes, [poly (K, 2) normalised ...])``."""
    classes, polys = [], []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                vals = line.split()
                if len(vals) < 7 or len(vals) % 2 == 0:
                    continue
                classes.append(int(float(vals[0])))
                polys.append(np.array([float(v) for v in vals[1:]]).reshape(-1, 2))
    return np.array(classes, np.int32), polys


def polygon_angle(poly: np.ndarray) -> float:
    """Rotation of an OBB polygon from its first edge, wrapped into (-pi/4,
    3pi/4): the head's decode range."""
    e = poly[1] - poly[0]
    ang = float(np.arctan2(e[1], e[0]))
    while ang >= 0.75 * np.pi:
        ang -= np.pi
    while ang < -0.25 * np.pi:
        ang += np.pi
    return ang


# ---------------------------------------------------------------- PIL's polygon fill

def _round_up(v: np.ndarray) -> np.ndarray:
    """PIL's ``ROUND_UP``: halves away from zero."""
    return np.where(v >= 0, np.floor(v + np.float32(0.5)), -np.floor(np.abs(v) + np.float32(0.5))).astype(np.int64)


def _roundf(v: np.float32) -> np.float32:
    """C's ``roundf``: halves away from zero, in float32."""
    return np.float32(np.sign(v) * np.floor(np.abs(np.float64(v)) + 0.5))


def _round_down(v: np.float32) -> int:
    """PIL's ``ROUND_DOWN`` of a float: halves towards zero."""
    half = np.float32(0.5)
    return int(math.ceil(v - half) if v >= 0 else -math.ceil(np.abs(v) - half))


def rasterize_polygon(poly_px: np.ndarray, size: int) -> np.ndarray:
    """Fill a polygon (pixel coordinates at the target resolution) into a
    ``(size, size)`` float32 mask, as PIL's ``ImageDraw.polygon(fill=1)``
    on an ``L`` image fills it: vertices cast to integers, edges' x in
    float32, each scanline's crossings sorted and filled between pairs
    (the left end rounded up, the right end rounded down, both inclusive),
    horizontal edges drawn whole, and PIL's rules for an edge ending on a
    row and for a corner that would leave a gap to the next row."""
    xy = np.trunc(np.asarray(poly_px, np.float64).reshape(-1)).astype(np.int64)  # PIL casts the vertices to int
    n_pts = len(xy) // 2
    mask = np.zeros((size, size), np.float32)
    if n_pts == 0:
        return mask

    edges = []  # (x0, y0, xmin, ymin, xmax, ymax, dx)

    def add_edge(x0, y0, x1, y1):
        dx = np.float32(0.0) if y0 == y1 else np.float32(np.float32(x1 - x0) / np.float32(y1 - y0))
        edges.append([x0, y0, min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1), dx])

    i = 0
    for i in range(n_pts - 1):
        x0, y0, x1, y1 = (int(v) for v in xy[2 * i:2 * i + 4])
        if y0 == y1 and i != 0 and y0 == xy[2 * i - 1]:  # a horizontal edge right after another
            last = edges[-1]
            if x1 > x0 > xy[2 * i - 2]:
                last[4] = x1
                continue
            if x1 < x0 < xy[2 * i - 2]:
                last[2] = x1
                continue
        add_edge(x0, y0, x1, y1)
    if n_pts > 1:
        i = n_pts - 1
    if xy[2 * i] != xy[0] or xy[2 * i + 1] != xy[1]:
        add_edge(int(xy[2 * i]), int(xy[2 * i + 1]), int(xy[0]), int(xy[1]))

    def hline(x0, y, x1):
        if 0 <= y < size:
            x0, x1 = max(x0, 0), min(x1, size - 1)
            if x0 <= x1:
                mask[y, x0:x1 + 1] = 1.0

    def x_at(e, y):
        return np.float32(np.float32(y - e[1]) * e[6] + np.float32(e[0]))

    ymin, ymax, table = size - 1, 0, []
    for e in edges:
        ymin, ymax = min(ymin, e[3]), max(ymax, e[5])
        if e[3] == e[5]:
            hline(e[2], e[3], e[4])
            continue
        table.append(e)
    ymin, ymax = max(ymin, 0), min(ymax, size)
    xx = np.zeros(2 * len(table) + 1, np.float32)
    one = np.float32(1.0)
    for y in range(ymin, ymax + 1):
        j = 0
        for i_edge, cur in enumerate(table):
            if not (cur[3] <= y <= cur[5]):
                continue
            x = x_at(cur, y)
            xx[j] = x
            j += 1
            if y == cur[5] and y < ymax:
                xx[j] = x  # an edge ending on this row counts twice
                j += 1
            elif cur[6] != 0 and y in (cur[3], cur[5]):
                # a corner on this row: where an earlier edge ends or starts
                # at the same pixel and both reach the next row (the row
                # before, at the edge's end), a crossing beyond both of
                # that row's moves to one pixel past them, so the corner
                # joins the next row
                adj_row = y - 1 if y == cur[5] else y + 1
                for other in table[:i_edge]:
                    if (y not in (other[3], other[5]) or other[6] == 0 or _roundf(x) != _roundf(x_at(other, y))
                            or not other[3] <= adj_row <= other[5]):
                        continue
                    a, b = x_at(cur, adj_row), x_at(other, adj_row)
                    if x > a + one and x > b + one:
                        xx[j - 1] = _roundf(max(a, b)) + one
                    elif x < a - one and x < b - one:
                        xx[j - 1] = _roundf(min(a, b)) - one
                    break
        row = np.sort(xx[:j])
        for i in range(1, j, 2):
            x_start = int(_round_up(row[i - 1]))
            x_end = _round_down(row[i])
            if x_end >= x_start:
                hline(x_start, y, x_end)
    return mask


# ---------------------------------------------------------------- examples

def letterbox_image(img: np.ndarray, size: int) -> np.ndarray:
    """An RGB uint8 image ``(H, W, 3)`` -> ``(size, size, 3)`` float32 in [0,
    1], letterboxed: PIL's bilinear resize to the aspect-preserving size,
    centred on the 114-gray pad."""
    h0, w0 = img.shape[:2]
    scale, px, py = letterbox_transform(w0, h0, size)
    nw, nh = round(w0 * scale), round(h0 * scale)
    resized = resize_bilinear(img, nw, nh).astype(np.float32) / 255.0
    out = np.full((size, size, 3), LETTERBOX_FILL, np.float32)
    x0, y0 = int(round(px)), int(round(py))
    out[y0:y0 + nh, x0:x0 + nw] = resized[..., :3]
    return out


def map_polygon(poly_norm: np.ndarray, w0: int, h0: int, size: int) -> np.ndarray:
    """A normalised label polygon -> letterboxed model-input pixels."""
    scale, px, py = letterbox_transform(w0, h0, size)
    pts = np.asarray(poly_norm, np.float64) * np.array([w0, h0])
    return (pts * scale + np.array([px, py])).astype(np.float32)


def load_example(img_path: str, lbl_path: str, img_size: int, task: str = "detect", return_kpts: bool = False):
    """Decode + letterbox one example; boxes to xyxy pixels at ``img_size``.
    Returns ``(image, classes, boxes, (scale, pad_x, pad_y, w0, h0))`` (with
    ``return_kpts``, the pose keypoints before the transform).  Pose rows go
    through `parse_pose_label`."""
    img = to_rgb(read_image(img_path))
    h0, w0 = img.shape[:2]
    scale, px, py = letterbox_transform(w0, h0, img_size)
    arr = letterbox_image(img, img_size)
    kp = None
    if task == "pose":
        classes, cxcywh, kp = parse_pose_label(lbl_path)
    else:
        classes, cxcywh = parse_label_file(lbl_path)
    if len(cxcywh):
        cx, cy, bw, bh = (cxcywh[:, 0], cxcywh[:, 1], cxcywh[:, 2], cxcywh[:, 3])
        boxes = np.stack([(cx - bw / 2) * w0 * scale + px, (cy - bh / 2) * h0 * scale + py,
                          (cx + bw / 2) * w0 * scale + px, (cy + bh / 2) * h0 * scale + py], axis=1).astype(np.float32)
    else:
        boxes = np.zeros((0, 4), np.float32)
    if return_kpts:
        return arr, classes, boxes, kp, (scale, px, py, w0, h0)
    return arr, classes, boxes, (scale, px, py, w0, h0)


def _fill_kpts(dst: np.ndarray, kp: np.ndarray, scale, px, py, w0, h0) -> None:
    for j, kj in enumerate(kp[:dst.shape[0]]):
        dst[j, :, 0] = kj[:, 0] * w0 * scale + px
        dst[j, :, 1] = kj[:, 1] * h0 * scale + py
        dst[j, :, 2] = kj[:, 2]


def _flip_angles(ang):
    """A horizontal mirror negates an orientation; wrapped back into (-pi/4,
    3pi/4) (an OBB's angle is pi-periodic)."""
    fa = -ang
    return (torch.where(fa <= -0.25 * math.pi, fa + math.pi, fa) if isinstance(fa, torch.Tensor)
            else np.where(fa <= -0.25 * np.pi, fa + np.pi, fa))


def _nearest_rows(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")``'s source rows, half-pixel
    centred (torch's ``nearest-exact``): ``floor((i + 0.5) * in / out)``
    in float32."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * n_in / n_out).long()


class DeviceYoloDataset:
    """A dataset held on the device: every image and label is loaded once;
    a batch is a gather driven by one small index transfer a step.  The
    horizontal flip and the zoom-out (``scale_aug``) run on the device from
    per-sample draws.

    The draws are the JAX package's, from ``np.random.default_rng(seed)``
    in the same order (the indices, the flips, the zoom factors), so a
    seed gives the same batches there and here.  ``scale_aug``: discrete
    zoom-out factors (e.g. ``(0.5, 0.67, 0.83, 1.0)``) sampled per example:
    the image is resized by the factor (bilinear, antialiased on downscale,
    as ``jax.image.resize`` is) and pasted centred on the letterbox gray;
    labels move as ``v' = v * f + s * (1 - f) / 2``.  ``device=None`` means
    the card."""

    def __init__(self, root: str, img_size: int = 640, batch_size: int = 16, max_gt: int = 32, seed: int = 0,
                 augment: bool = False, task: str = "detect", label_root: str | None = None,
                 pairs: list | None = None, n_kpt: int = 4, scale_aug: tuple = (), device=None):
        from icp_slam_yolo_tpu_torch.device import resolve_device

        pairs = pairs if pairs is not None else find_pairs(root, label_root)
        if not pairs:
            raise FileNotFoundError(f"no images under {root}")
        if task == "pose" and augment and n_kpt != len(KPT_FLIP_PERM):
            raise ValueError(f"hflip augment assumes {len(KPT_FLIP_PERM)} tl/tr/br/bl keypoints, got n_kpt={n_kpt}")
        n, s, m = len(pairs), img_size, max_gt
        sp = s // 4  # the proto masks' resolution
        images = np.zeros((n, s, s, 3), np.float32)
        boxes = np.zeros((n, m, 4), np.float32)
        classes = np.zeros((n, m), np.int32)
        valid = np.zeros((n, m), bool)
        angles = np.zeros((n, m), np.float32)
        masks = np.zeros((n, m, sp, sp), np.float32) if task == "segment" else None
        kpts = np.zeros((n, m, n_kpt, 3), np.float32) if task == "pose" else None
        for i, (ip, lp) in enumerate(pairs):
            img, cls, bxs, kp, (scale, px, py, w0, h0) = load_example(ip, lp, s, task, return_kpts=True)
            images[i] = img
            k = min(len(cls), m)
            boxes[i, :k] = bxs[:k]
            classes[i, :k] = cls[:k]
            valid[i, :k] = True
            if task == "obb":
                _, polys = parse_polygons(lp)
                for j, poly in enumerate(polys[:m]):
                    angles[i, j] = polygon_angle(map_polygon(poly, w0, h0, s))
            elif task == "segment":
                _, polys = parse_polygons(lp)
                for j, poly in enumerate(polys[:m]):
                    masks[i, j] = rasterize_polygon(map_polygon(poly, w0, h0, s) * (sp / s), sp)
            elif task == "pose":
                _fill_kpts(kpts[i], kp, scale, px, py, w0, h0)
        self.n, self.img_size, self.batch_size = n, s, batch_size
        self.augment, self.task = augment, task
        self.scale_aug = tuple(scale_aug)
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        data = {"images": images, "boxes": boxes, "classes": classes, "valid": valid}
        if task == "obb":
            data["angles"] = angles
        if task == "segment":
            data["masks"] = masks
        if task == "pose":
            data["kpts"] = kpts
        self._d = {k: torch.from_numpy(v).to(self.device) for k, v in data.items()}
        self._kpt_perm = torch.from_numpy(KPT_FLIP_PERM).to(self.device)
        # made once: a tensor built from host values inside a step would wait for the card
        self._factors = torch.tensor(self.scale_aug or (1.0,), dtype=torch.float32).to(self.device)

    def __len__(self):
        return self.n

    def draws(self) -> np.ndarray:
        """The next batch's draws ``(3, B)`` int64: indices, flips, zoom
        factors' indices (the JAX package's order of draws)."""
        bsz = self.batch_size
        idx = self.rng.choice(self.n, bsz, replace=self.n < bsz)
        flips = self.rng.random(bsz) < 0.5 if self.augment else np.zeros(bsz, bool)
        sidx = self.rng.integers(0, len(self.scale_aug), bsz) if self.scale_aug else np.zeros(bsz, np.int64)
        return np.stack([idx, flips, sidx]).astype(np.int64)

    def gather(self, draws: torch.Tensor) -> dict:
        """One batch on the device from ``draws`` (on the device)."""
        s, d = self.img_size, self._d
        idx, flips, sidx = draws[0], draws[1].bool(), draws[2]
        imgs, bxs = d["images"][idx], d["boxes"][idx]
        if self.augment:
            imgs = torch.where(flips[:, None, None, None], imgs.flip(2), imgs)
            fb = torch.stack([s - bxs[..., 2], bxs[..., 1], s - bxs[..., 0], bxs[..., 3]], dim=-1)
            bxs = torch.where(flips[:, None, None], fb, bxs)
        out = {"images": imgs, "boxes": bxs, "classes": d["classes"][idx], "valid": d["valid"][idx]}
        if "angles" in d:
            ang = d["angles"][idx]
            out["angles"] = torch.where(flips[:, None], _flip_angles(ang), ang) if self.augment else ang
        if "masks" in d:
            mk = d["masks"][idx]
            out["masks"] = torch.where(flips[:, None, None, None], mk.flip(3), mk) if self.augment else mk
        if "kpts" in d:
            kp = d["kpts"][idx]
            if self.augment:
                fk = torch.cat([s - kp[..., :1], kp[..., 1:]], dim=-1)[:, :, self._kpt_perm]
                kp = torch.where(flips[:, None, None, None], fk, kp)
            out["kpts"] = kp
        if self.scale_aug:
            self._zoom_out(out, sidx)
        return out

    def _zoom_out(self, out: dict, sidx: torch.Tensor) -> None:
        """The centred zoom-out: one variant a factor for the whole batch,
        then each sample's pick (angles are scale-invariant)."""
        s = self.img_size
        b_idx = torch.arange(sidx.shape[0], device=sidx.device)
        variants = []
        for f in self.scale_aug:
            if f == 1.0:
                variants.append(out["images"])
                continue
            nf = int(round(s * f))
            r = F.interpolate(out["images"].permute(0, 3, 1, 2), size=(nf, nf), mode="bilinear",
                              align_corners=False, antialias=True).permute(0, 2, 3, 1)
            canvas = torch.full_like(out["images"], LETTERBOX_FILL)
            pad0 = (s - nf) // 2
            canvas[:, pad0:pad0 + nf, pad0:pad0 + nf] = r
            variants.append(canvas)
        out["images"] = torch.stack(variants)[sidx, b_idx]
        fv = self._factors[sidx]  # (B,)
        off = s * (1.0 - fv) / 2.0
        out["boxes"] = out["boxes"] * fv[:, None, None] + off[:, None, None]
        if "kpts" in out:
            kp = out["kpts"]
            xy = kp[..., :2] * fv[:, None, None, None] + off[:, None, None, None]
            out["kpts"] = torch.cat([xy, kp[..., 2:]], dim=-1)
        if "masks" in out:
            mk = out["masks"]  # (B, M, sp, sp)
            sp = mk.shape[-1]
            mvars = []
            for f in self.scale_aug:
                if f == 1.0:
                    mvars.append(mk)
                    continue
                nf = max(int(round(sp * f)), 1)
                rows = _nearest_rows(sp, nf, mk.device)
                cv = torch.zeros_like(mk)
                p0 = (sp - nf) // 2
                cv[:, :, p0:p0 + nf, p0:p0 + nf] = mk[:, :, rows][:, :, :, rows]
                mvars.append(cv)
            out["masks"] = torch.stack(mvars)[sidx, b_idx]

    def __iter__(self):
        while True:
            yield self.gather(torch.from_numpy(self.draws()).to(self.device, non_blocking=True))


class YoloDataset:
    """A shuffled host iterator of numpy batches with fixed-shape padded
    labels; its order and flips come from ``random.Random(seed)``, as in
    the JAX package."""

    def __init__(self, root: str, img_size: int = 640, batch_size: int = 16, max_gt: int = 32, seed: int = 0,
                 augment: bool = False, task: str = "detect"):
        self.pairs = find_pairs(root)
        if not self.pairs:
            raise FileNotFoundError(f"no images under {root}")
        self.img_size, self.batch_size, self.max_gt = img_size, batch_size, max_gt
        self.rng = random.Random(seed)
        self.augment = augment  # the horizontal flip (Ultralytics fliplr 0.5)
        self.task = task  # "obb" adds the angles, "pose" the keypoints

    def __len__(self):
        return len(self.pairs)

    def __iter__(self):
        order = list(range(len(self.pairs)))
        while True:
            self.rng.shuffle(order)
            for start in range(0, len(order) - self.batch_size + 1, self.batch_size):
                yield self._batch([self.pairs[i] for i in order[start:start + self.batch_size]])

    def _batch(self, pairs):
        b, s, m = self.batch_size, self.img_size, self.max_gt
        images = np.zeros((b, s, s, 3), np.float32)
        boxes = np.zeros((b, m, 4), np.float32)
        classes = np.zeros((b, m), np.int32)
        valid = np.zeros((b, m), bool)
        angles = np.zeros((b, m), np.float32) if self.task == "obb" else None
        kpts = np.zeros((b, m, 4, 3), np.float32) if self.task == "pose" else None
        for i, (ip, lp) in enumerate(pairs):
            img, cls, bxs, kp, (scale, px, py, w0, h0) = load_example(ip, lp, s, self.task, return_kpts=True)
            if angles is not None:
                _, polys = parse_polygons(lp)
                for j, poly in enumerate(polys[:m]):
                    angles[i, j] = polygon_angle(map_polygon(poly, w0, h0, s))
            if kpts is not None and kp is not None:
                _fill_kpts(kpts[i], kp, scale, px, py, w0, h0)
            if self.augment and self.rng.random() < 0.5:
                img = img[:, ::-1]
                if len(bxs):
                    bxs = np.stack([s - bxs[:, 2], bxs[:, 1], s - bxs[:, 0], bxs[:, 3]], axis=1)
                if angles is not None:
                    angles[i] = _flip_angles(angles[i])
                if kpts is not None:
                    fk = kpts[i].copy()
                    fk[..., 0] = s - fk[..., 0]
                    kpts[i] = fk[:, KPT_FLIP_PERM]
            images[i] = img
            k = min(len(cls), m)
            boxes[i, :k] = bxs[:k]
            classes[i, :k] = cls[:k]
            valid[i, :k] = True
        batch = {"images": images, "boxes": boxes, "classes": classes, "valid": valid}
        if angles is not None:
            batch["angles"] = angles
        if kpts is not None:
            batch["kpts"] = kpts
        return batch
