"""Instance-mask assembly and mask -> polygon conversion (segmentation task);
the counterpart of the JAX package's ``models/segment.py``."""

from __future__ import annotations

import numpy as np
import torch


def assemble_masks(protos: torch.Tensor, coeffs: torch.Tensor, boxes: torch.Tensor, img_size: int):
    """Combine prototype masks with per-detection coefficients.

    ``protos (Hp, Wp, P)`` prototype bases (1/4 input resolution), ``coeffs
    (K, P)``, ``boxes (K, 4)`` xyxy in input pixels.  Returns ``(K, Hp, Wp)``
    float32 mask probabilities (sigmoid), zeroed outside each box."""
    hp, wp, _ = protos.shape
    m = torch.sigmoid(torch.einsum("hwp,kp->khw", protos.float(), coeffs.float()))
    scale = hp / img_size
    ys = torch.arange(hp, dtype=torch.float32, device=protos.device)[None, :, None]
    xs = torch.arange(wp, dtype=torch.float32, device=protos.device)[None, None, :]
    b = boxes.float() * scale
    inside = ((xs >= b[:, 0, None, None]) & (xs < b[:, 2, None, None])
              & (ys >= b[:, 1, None, None]) & (ys < b[:, 3, None, None]))
    return m * inside


def mask_to_polygon(mask: np.ndarray, threshold: float = 0.5, max_points: int = 64) -> np.ndarray:
    """Binary mask -> single outer polygon ``(P, 2)`` in mask pixels: the
    boundary cells ordered by angle around their centroid, subsampled to
    ``max_points``."""
    binary = np.asarray(mask) >= threshold
    if not binary.any():
        return np.zeros((0, 2))
    padded = np.pad(binary, 1)  # so the boundary is closed
    up = np.roll(padded, 1, 0)
    down = np.roll(padded, -1, 0)
    left = np.roll(padded, 1, 1)
    right = np.roll(padded, -1, 1)
    boundary = padded & ~(up & down & left & right)
    ys, xs = np.nonzero(boundary)
    pts = np.stack([xs - 1, ys - 1], axis=1).astype(np.float64)
    c = pts.mean(axis=0)
    ang = np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0])
    pts = pts[np.argsort(ang)]
    if len(pts) > max_points:
        idx = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[idx]
    return pts


def masks_to_label_rows(masks: np.ndarray, classes: np.ndarray, img_size: int, threshold: float = 0.5):
    """Masks -> normalised YOLO polygon label rows."""
    rows = []
    hp = masks.shape[1]
    for mask, cls in zip(masks, classes):
        poly = mask_to_polygon(mask, threshold)
        if len(poly) < 3:
            continue
        flat = " ".join(f"{v:.6f}" for xy in poly / hp for v in xy)
        rows.append(f"{int(cls)} {flat}")
    return rows
