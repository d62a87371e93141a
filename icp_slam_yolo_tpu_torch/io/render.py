"""Map rendering helpers: scan overlays, robot pose, ICP debug view and the
operator overlay on camera frames.  Numpy only: (H, W, 3) uint8 RGB out.

Counterpart of the JAX package's ``io/render.py``.  `annotate_detections`
draws what that module draws with an imaging package's ``ImageDraw``: the
boxes (2-pixel outline), keypoint dots and the filled readout panel land on
the same pixels (`_outline`, `_ellipse_mask` follow its rasterisation rules:
coordinates truncated toward zero, the outline's side lines stopping one
pixel short, the filled ellipse traced by its quarter-ellipse walk).  The
text comes from the small 5 x 7 bitmap font kept here, drawn inside the 12
rows the other font takes, so the two renderings differ only in those rows.
"""

from __future__ import annotations

import numpy as np

from icp_slam_yolo_tpu_torch.config import MapConfig


def occupancy_rgb(occ: np.ndarray) -> np.ndarray:
    g = ((1.0 - np.asarray(occ)) * 255.0).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _to_px(points_xy: np.ndarray, map_cfg: MapConfig):
    cx, cy = map_cfg.center_px
    res = map_cfg.resolution_mm_per_px
    px = np.trunc(cx + points_xy[:, 0] / res).astype(int)
    py = np.trunc(cy - points_xy[:, 1] / res).astype(int)
    return px, py


def draw_points(img: np.ndarray, points_xy: np.ndarray, map_cfg: MapConfig,
                color=(0, 255, 0), radius: int = 1) -> np.ndarray:
    h, w = img.shape[:2]
    px, py = _to_px(np.asarray(points_xy), map_cfg)
    for dx in range(-radius, radius + 1):
        for dy in range(-radius, radius + 1):
            x = np.clip(px + dx, 0, w - 1)
            y = np.clip(py + dy, 0, h - 1)
            ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
            img[y[ok], x[ok]] = color
    return img


def draw_robot_pose(img: np.ndarray, pose_se2, map_cfg: MapConfig,
                    axis_length_mm: float = 300.0) -> np.ndarray:
    h, w = img.shape[:2]
    x, y, theta = pose_se2
    px, py = _to_px(np.asarray([[x, y]]), map_cfg)
    px, py = int(px[0]), int(py[0])
    ex = px + axis_length_mm * np.cos(theta) / map_cfg.resolution_mm_per_px
    ey = py - axis_length_mm * np.sin(theta) / map_cfg.resolution_mm_per_px
    n = 32
    xs = np.linspace(px, ex, n).astype(int)
    ys = np.linspace(py, ey, n).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = (255, 0, 0)
    for dx in (-2, -1, 0, 1, 2):
        for dy in (-2, -1, 0, 1, 2):
            if dx * dx + dy * dy <= 4 and 0 <= py + dy < h and 0 <= px + dx < w:
                img[py + dy, px + dx] = (0, 0, 255)
    return img


def draw_target(img: np.ndarray, target_xy, map_cfg: MapConfig, color=(255, 255, 0)) -> np.ndarray:
    return draw_points(img, np.asarray([target_xy]), map_cfg, color=color, radius=3)


def icp_debug_view(map_points_xy: np.ndarray, scan_points_xy: np.ndarray, pose_se2,
                   size_px: int = 600, mm_per_px: float = 30.0) -> np.ndarray:
    """Map (blue) vs raw scan (green) in the ROBOT frame (the reference
    panel's second window)."""
    img = np.zeros((size_px, size_px, 3), np.uint8)
    x, y, theta = pose_se2
    c, s = np.cos(-theta), np.sin(-theta)

    def to_robot(pts):
        p = np.asarray(pts, float).reshape(-1, 2) - [x, y]
        return np.stack([c * p[:, 0] - s * p[:, 1], s * p[:, 0] + c * p[:, 1]], axis=1)

    def put(pts_robot, color):
        px = (size_px // 2 + pts_robot[:, 0] / mm_per_px).astype(int)
        py = (size_px // 2 - pts_robot[:, 1] / mm_per_px).astype(int)
        ok = (px >= 0) & (px < size_px) & (py >= 0) & (py < size_px)
        img[py[ok], px[ok]] = color

    if len(map_points_xy):
        put(to_robot(map_points_xy), (80, 120, 255))
    if len(scan_points_xy):
        put(np.asarray(scan_points_xy, float).reshape(-1, 2), (0, 255, 0))
    img[size_px // 2 - 2 : size_px // 2 + 3, size_px // 2 - 2 : size_px // 2 + 3] = (255, 0, 0)
    return img


# ------------------------------------------------------------- raster shapes

def _hline(img: np.ndarray, x0: int, y: int, x1: int, color) -> None:
    h, w = img.shape[:2]
    if 0 <= y < h:
        lo, hi = max(min(x0, x1), 0), min(max(x0, x1), w - 1)
        if lo <= hi:
            img[y, lo:hi + 1] = color


def _vline(img: np.ndarray, x: int, ya: int, yb: int, color) -> None:
    """The points from ``ya`` toward ``yb``, ``yb`` itself left out."""
    h, w = img.shape[:2]
    if ya == yb or not 0 <= x < w:
        return
    lo, hi = (ya, yb - 1) if yb > ya else (yb + 1, ya)
    lo, hi = max(lo, 0), min(hi, h - 1)
    if lo <= hi:
        img[lo:hi + 1, x] = color


def _outline(img: np.ndarray, box, color, width: int = 2) -> None:
    """A rectangle's outline ``width`` pixels wide: two rows at each of the
    top and bottom, then the side columns between them."""
    x0, y0, x1, y1 = (int(v) for v in box)
    for i in range(width):
        _hline(img, x0, y0 + i, x1, color)
        _hline(img, x0, y1 - i, x1, color)
        _vline(img, x1 - i, y0 + width, y1 - width + 1, color)
        _vline(img, x0 + i, y0 + width, y1 - width + 1, color)


def _fill_rect(img: np.ndarray, box, color) -> None:
    x0, y0, x1, y1 = (int(v) for v in box)
    for y in range(y0, y1 + 1):
        _hline(img, x0, y, x1, color)


def _ellipse_mask(a: int, b: int) -> np.ndarray:
    """The filled ellipse in a box ``a + 1`` wide and ``b + 1`` high: a walk
    along one quarter in doubled coordinates (from ``(a, b % 2)`` to
    ``(a % 2, b)``, each step to the neighbour nearest the curve), each row
    spanning the walk's largest x there, mirrored."""
    mask = np.zeros((b + 1, a + 1), bool)
    if a < 0 or b < 0 or a + b < 1:
        return mask
    a2, b2 = a * a, b * b

    def off(x, y):
        return abs(a2 * y * y + b2 * x * x - a2 * b2)

    cx, cy, rows = a, b % 2, {}
    while True:
        rows.setdefault(cy, cx)
        if cx == a % 2 and cy == b:
            break
        nx, ny, best = cx, cy + 2, off(cx, cy + 2)
        if cx > 1:
            for tx, ty in ((cx - 2, cy + 2), (cx - 2, cy)):
                d = off(tx, ty)
                if best > d:
                    nx, ny, best = tx, ty, d
        cx, cy = nx, ny
    for y, r in rows.items():
        for yy in (y, -y):
            mask[(yy + b) // 2, (a - r) // 2:(a + r) // 2 + 1] = True
    return mask


def _fill_ellipse(img: np.ndarray, box, color) -> None:
    x0, y0, x1, y1 = (int(v) for v in box)
    mask = _ellipse_mask(x1 - x0, y1 - y0)
    h, w = img.shape[:2]
    ys, xs = np.nonzero(mask)
    ys, xs = ys + y0, xs + x0
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


# 5 x 7 glyphs, one 5-bit row each (the high bit is the left column)
_FONT = {
    "0": (0x0E, 0x11, 0x13, 0x15, 0x19, 0x11, 0x0E), "1": (0x04, 0x0C, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "2": (0x0E, 0x11, 0x01, 0x02, 0x04, 0x08, 0x1F), "3": (0x1F, 0x02, 0x04, 0x02, 0x01, 0x11, 0x0E),
    "4": (0x02, 0x06, 0x0A, 0x12, 0x1F, 0x02, 0x02), "5": (0x1F, 0x10, 0x1E, 0x01, 0x01, 0x11, 0x0E),
    "6": (0x06, 0x08, 0x10, 0x1E, 0x11, 0x11, 0x0E), "7": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x08, 0x08),
    "8": (0x0E, 0x11, 0x11, 0x0E, 0x11, 0x11, 0x0E), "9": (0x0E, 0x11, 0x11, 0x0F, 0x01, 0x02, 0x0C),
    "a": (0x00, 0x00, 0x0E, 0x01, 0x0F, 0x11, 0x0F), "b": (0x10, 0x10, 0x16, 0x19, 0x11, 0x11, 0x1E),
    "c": (0x00, 0x00, 0x0E, 0x10, 0x10, 0x11, 0x0E), "d": (0x01, 0x01, 0x0D, 0x13, 0x11, 0x11, 0x0F),
    "e": (0x00, 0x00, 0x0E, 0x11, 0x1F, 0x10, 0x0E), "f": (0x06, 0x09, 0x08, 0x1C, 0x08, 0x08, 0x08),
    "g": (0x00, 0x0F, 0x11, 0x11, 0x0F, 0x01, 0x0E), "h": (0x10, 0x10, 0x16, 0x19, 0x11, 0x11, 0x11),
    "i": (0x04, 0x00, 0x0C, 0x04, 0x04, 0x04, 0x0E), "j": (0x02, 0x00, 0x06, 0x02, 0x02, 0x12, 0x0C),
    "k": (0x10, 0x10, 0x12, 0x14, 0x18, 0x14, 0x12), "l": (0x0C, 0x04, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "m": (0x00, 0x00, 0x1A, 0x15, 0x15, 0x11, 0x11), "n": (0x00, 0x00, 0x16, 0x19, 0x11, 0x11, 0x11),
    "o": (0x00, 0x00, 0x0E, 0x11, 0x11, 0x11, 0x0E), "p": (0x00, 0x00, 0x1E, 0x11, 0x1E, 0x10, 0x10),
    "q": (0x00, 0x00, 0x0D, 0x13, 0x0F, 0x01, 0x01), "r": (0x00, 0x00, 0x16, 0x19, 0x10, 0x10, 0x10),
    "s": (0x00, 0x00, 0x0E, 0x10, 0x0E, 0x01, 0x1E), "t": (0x08, 0x08, 0x1C, 0x08, 0x08, 0x09, 0x06),
    "u": (0x00, 0x00, 0x11, 0x11, 0x11, 0x13, 0x0D), "v": (0x00, 0x00, 0x11, 0x11, 0x11, 0x0A, 0x04),
    "w": (0x00, 0x00, 0x11, 0x11, 0x15, 0x15, 0x0A), "x": (0x00, 0x00, 0x11, 0x0A, 0x04, 0x0A, 0x11),
    "y": (0x00, 0x00, 0x11, 0x11, 0x0F, 0x01, 0x0E), "z": (0x00, 0x00, 0x1F, 0x02, 0x04, 0x08, 0x1F),
    ".": (0x00, 0x00, 0x00, 0x00, 0x00, 0x0C, 0x0C), "-": (0x00, 0x00, 0x00, 0x1F, 0x00, 0x00, 0x00),
    "+": (0x00, 0x04, 0x04, 0x1F, 0x04, 0x04, 0x00), ":": (0x00, 0x0C, 0x0C, 0x00, 0x0C, 0x0C, 0x00),
    "<": (0x02, 0x04, 0x08, 0x10, 0x08, 0x04, 0x02), ">": (0x08, 0x04, 0x02, 0x01, 0x02, 0x04, 0x08),
    "/": (0x00, 0x01, 0x02, 0x04, 0x08, 0x10, 0x00), "%": (0x18, 0x19, 0x02, 0x04, 0x08, 0x13, 0x03),
}
TEXT_ROWS = 12  # the rows below a text's origin that its glyphs may touch


def draw_text(img: np.ndarray, xy, text: str, color) -> None:
    """``text`` in the 5 x 7 font, 6 pixels a character, its glyphs in rows
    ``y + 2 .. y + 8`` of the origin ``xy`` (truncated toward zero); a
    character without a glyph leaves a blank cell."""
    x0, y0 = (int(v) for v in xy)
    h, w = img.shape[:2]
    for k, ch in enumerate(text.lower()):
        for r, bits in enumerate(_FONT.get(ch, ())):
            y = y0 + 2 + r
            for c in range(5):
                x = x0 + 6 * k + c
                if bits >> (4 - c) & 1 and 0 <= y < h and 0 <= x < w:
                    img[y, x] = color


def annotate_detections(frame: np.ndarray, detections: dict, camera_data: dict | None = None) -> np.ndarray:
    """Draw detection boxes, scores, keypoints and the pallet-alignment
    readout onto a camera frame (the reference's operator overlay: a box
    per detection and the alignment lines on the stereo frames).

    ``detections`` is a `Detector.__call__` output dict (``boxes`` (N, 4)
    xyxy in frame pixels, ``scores``, optional ``keypoints`` (N, K, 3));
    ``camera_data`` is the stream's alignment payload ({yaw_deg,
    distance_mm, lateral_mm, direction}).  Returns a new (H, W, 3) uint8
    RGB array."""
    img = np.array(np.ascontiguousarray(frame, np.uint8))
    boxes = np.asarray(detections.get("boxes", np.zeros((0, 4))), float)
    scores = np.asarray(detections.get("scores", np.zeros(len(boxes))), float)
    for box, score in zip(boxes, scores):
        x0, y0, x1, y1 = (float(v) for v in box[:4])
        _outline(img, (x0, y0, x1, y1), (0, 255, 0))
        draw_text(img, (x0 + 2, max(0.0, y0 - 12)), f"pallet {score:.2f}", (0, 255, 0))
    kpts = detections.get("keypoints")
    if kpts is not None:
        for inst in np.asarray(kpts, float):
            for kx, ky, vis in inst:
                if vis >= 0.5:
                    _fill_ellipse(img, (kx - 3, ky - 3, kx + 3, ky + 3), (255, 0, 255))
    if camera_data is not None:
        lines = [
            f"dist {camera_data['distance_mm']:.0f} mm",
            f"yaw {camera_data['yaw_deg']:.1f} deg",
            f"lateral {camera_data['lateral_mm']:.0f} mm",
            {-1: "<< steer left", 0: "aligned", 1: "steer right >>"}.get(int(camera_data.get("direction", 0)), ""),
        ]
        _fill_rect(img, (4, 4, 150, 8 + 13 * len(lines)), (0, 0, 0))
        for i, line in enumerate(lines):
            draw_text(img, (8, 6 + 13 * i), line, (255, 255, 0))
    return img
