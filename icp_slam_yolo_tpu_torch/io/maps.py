"""Map persistence: occupancy PNGs, pixel-coordinate point dumps, PCD files.
Counterpart of the JAX package's ``io/maps.py``, with the image codecs of
`utils.images` in place of an imaging package.

The reference's artifacts:
  * rendered occupancy PNG: grayscale ``(1 - p) * 255``;
  * ``.npy`` of map points in **pixel** coords ``(N, 2) int32`` using
    ``px = cx + x/res``, ``py = cy - y/res``;
  * PCD point clouds (ASCII written; ASCII and binary read).
"""

from __future__ import annotations

import numpy as np

from icp_slam_yolo_tpu_torch.config import MapConfig
from icp_slam_yolo_tpu_torch.utils.images import encode_png, read_image


def occupancy_to_image(occ: np.ndarray) -> np.ndarray:
    """Probability grid -> grayscale uint8."""
    return ((1.0 - np.asarray(occ)) * 255.0).astype(np.uint8)


def save_occupancy_png(occ: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(occupancy_to_image(occ)))


def _luminance(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")``: gray from an RGB(A) image, ITU-R 601-2 luma
    in 16-bit fixed point, ``(19595 R + 38470 G + 7471 B + 2^15) >> 16``;
    alpha is dropped."""
    if img.ndim == 2:
        return img
    if img.shape[2] <= 2:
        return img[..., 0]
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def load_occupancy_png(path: str) -> np.ndarray:
    """An occupancy grid from any image `read_image` reads (PNG, JPEG):
    its gray levels, ``1 - L / 255``."""
    img = _luminance(np.asarray(read_image(path), np.uint8)).astype(np.float32)
    return 1.0 - img / 255.0


def points_to_pixels(points_xy: np.ndarray, map_cfg: MapConfig) -> np.ndarray:
    """World mm -> ``(N, 2) int32`` pixel coords."""
    cx, cy = map_cfg.center_px
    res = map_cfg.resolution_mm_per_px
    px = np.trunc(cx + points_xy[:, 0] / res).astype(np.int32)
    py = np.trunc(cy - points_xy[:, 1] / res).astype(np.int32)
    return np.stack([px, py], axis=1)


def pixels_to_points(pixels: np.ndarray, map_cfg: MapConfig) -> np.ndarray:
    """Inverse of `points_to_pixels` (cell corners, no half-cell offset)."""
    cx, cy = map_cfg.center_px
    res = map_cfg.resolution_mm_per_px
    x = (pixels[:, 0].astype(np.float64) - cx) * res
    y = (cy - pixels[:, 1].astype(np.float64)) * res
    return np.stack([x, y], axis=1)


def save_map_points_npy(points_xy: np.ndarray, path: str, map_cfg: MapConfig = MapConfig()) -> None:
    np.save(path, points_to_pixels(np.asarray(points_xy), map_cfg))


def load_map_points_npy(path: str, map_cfg: MapConfig = MapConfig()) -> np.ndarray:
    return pixels_to_points(np.load(path), map_cfg)


def save_pcd(points: np.ndarray, path: str) -> None:
    """Minimal ASCII PCD v0.7 writer (xyz float32); z padded when absent."""
    pts = np.asarray(points, dtype=np.float32)
    if pts.shape[1] == 2:
        pts = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], axis=1)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {len(pts)}\nDATA ascii\n"
    )
    with open(path, "w") as f:
        f.write(header)
        for x, y, z in pts:
            f.write(f"{x:.6f} {y:.6f} {z:.6f}\n")


def load_pcd(path: str) -> np.ndarray:
    """PCD v0.7 reader (xyz), ASCII and binary (``DATA binary``: packed
    little-endian fields per point, what Open3D's writer emits)."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.index(b"DATA")  # the header is ASCII lines up to and including the DATA line
    nl = raw.index(b"\n", end)
    fields, sizes, types, counts, n_points = [], [], [], [], 0
    mode = raw[end:nl].split()[1].decode()
    for line in raw[:nl].decode("ascii", "replace").splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "FIELDS":
            fields = parts[1:]
        elif parts[0] == "SIZE":
            sizes = [int(v) for v in parts[1:]]
        elif parts[0] == "TYPE":
            types = parts[1:]
        elif parts[0] == "COUNT":
            counts = [int(v) for v in parts[1:]]
        elif parts[0] == "POINTS":
            n_points = int(parts[1])
    counts = counts or [1] * len(fields)

    if mode == "ascii":
        pts = []
        for line in raw[nl + 1:].decode("ascii", "replace").splitlines():
            vals = line.split()
            if len(vals) >= 3:
                pts.append([float(vals[0]), float(vals[1]), float(vals[2])])
        return np.asarray(pts, dtype=np.float32)
    if mode != "binary":
        raise ValueError(f"unsupported PCD DATA mode: {mode}")

    kind = {"F": "f", "U": "u", "I": "i"}
    dtype = np.dtype([(name, f"<{kind[t]}{s}", (c,) if c > 1 else ())
                      for name, s, t, c in zip(fields, sizes, types, counts)])
    rec = np.frombuffer(raw[nl + 1:], dtype=dtype, count=n_points)
    missing = [a for a in ("x", "y", "z") if a not in fields]
    if missing:
        raise ValueError(f"PCD file missing coordinate field(s) {missing}; FIELDS={fields}")
    cols = []
    for a in ("x", "y", "z"):
        col = rec[a].astype(np.float32)
        if col.ndim > 1:  # COUNT > 1: the first component of the subarray
            col = col[..., 0]
        cols.append(col.reshape(n_points))
    return np.stack(cols, axis=1)
