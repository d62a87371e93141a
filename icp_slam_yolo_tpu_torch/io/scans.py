"""LiDAR scan dataset loading and fixed-shape collation.

The on-disk format is defined by the reference's acquisition loop
(`duc/code python/read_lidar.py:132-143`): one ``.npy`` per scan, shape
``(N, 3)`` float64 rows ``[quality, angle_deg, distance_mm]`` (N varies,
19..405 in the bundled data), or ``(N, 2)`` cartesian which gets a zero z
column (`process.py:9-36`).

For the pipeline everything is padded to ``n_max`` rows with all-zero rows
(which fail every gate) and stacked to ``(T, n_max, 3)`` so the whole sequence
can live on the device with static per-scan shapes.  A numpy-only copy of the
JAX package's ``io/scans.py``.
"""

from __future__ import annotations

import os
import re
from typing import Sequence

import numpy as np

# a raw scan's gated cartesian points and SE(2) moves on the host (float64):
# the server's scan overlay and the pairwise-registration command read these;
# the pipeline gates on the device
from icp_slam_yolo_tpu_torch.reference_impl.oracle import polar_gate, se2_apply  # noqa: F401

# the two naming schemes in the bundled datasets:
#   Scan_data_1/Scan_data_{i}.npy   (i from 1)
#   scan_data_3/scan_{i}.npy        (i from 0)
_PATTERNS = ("Scan_data_{}.npy", "scan_{}.npy", "scan_data_{}.npy")


def load_scan(path: str) -> np.ndarray:
    """Load one scan; returns ``(N, 3)`` float64 ``[quality, angle, dist]`` rows.

    ``(N, 2)`` cartesian files are returned as-is (shape tagged by width), like
    `process.py:27-33`'s dispatch-on-shape.
    """
    arr = np.load(path)
    if arr.ndim != 2 or arr.shape[1] not in (2, 3):
        raise ValueError(f"bad scan shape {arr.shape} in {path}")
    return np.asarray(arr, dtype=np.float64)


def discover_sequence(directory: str) -> list[str]:
    """All scan files of a directory sorted by their numeric index."""
    files = []
    rx = re.compile(r"(\d+)\.npy$")
    for name in os.listdir(directory):
        m = rx.search(name)
        if m is not None and name.endswith(".npy"):
            files.append((int(m.group(1)), os.path.join(directory, name)))
    files.sort()
    return [p for _, p in files]


def sequence_paths(directory: str, start: int, end: int) -> list[str]:
    """Paths ``start..end-1`` following the reference's BASE_PATH scheme
    (`Config.py:1`, `slam_offline.py:13`); missing files are skipped, matching
    the reference's per-scan error-and-continue (`slam_offline.py:348-350`).
    """
    out = []
    for i in range(start, end):
        for pat in _PATTERNS:
            p = os.path.join(directory, pat.format(i))
            if os.path.exists(p):
                out.append(p)
                break
    return out


def pad_scan(scan: np.ndarray, n_max: int) -> np.ndarray:
    """Pad/truncate one raw scan to ``(n_max, 3)`` float32; padding rows are
    all-zero (quality 0 fails every gate)."""
    out = np.zeros((n_max, 3), np.float32)
    if scan.shape[1] == 2:  # cartesian: store as (quality=inf marker handled upstream)
        raise ValueError("cartesian scans must be converted before padding")
    m = min(len(scan), n_max)
    out[:m] = scan[:m]
    return out


def load_sequence(directory: str, start: int = 1, end: int | None = None, n_max: int = 512):
    """Load, pad and stack a scan directory.

    Returns ``(scans, counts, paths)``: ``(T, n_max, 3)`` float32, ``(T,)``
    int32 raw row counts, and the file list.
    """
    if end is None:
        paths = discover_sequence(directory)[max(0, start - 1):]
    else:
        paths = sequence_paths(directory, start, end)
    scans = np.zeros((len(paths), n_max, 3), np.float32)
    counts = np.zeros(len(paths), np.int32)
    for t, p in enumerate(paths):
        raw = load_scan(p)
        scans[t] = pad_scan(raw, n_max)
        counts[t] = len(raw)
    return scans, counts, paths


def collate(scans: Sequence[np.ndarray], n_max: int = 512) -> np.ndarray:
    """Stack already-loaded raw scans into a padded batch ``(B, n_max, 3)``."""
    out = np.zeros((len(scans), n_max, 3), np.float32)
    for i, s in enumerate(scans):
        out[i] = pad_scan(s, n_max)
    return out
