"""The numbers the check compares: how far what the program produced lies
from what the plain reference produces from the same inputs.

Every function takes the program's answers (or the control's, computed by
the reference in a lower precision) and the reference's, and returns a
number that is 0 when they agree exactly; the limits are in the cell's
file.
"""

from __future__ import annotations

import torch

from portbench.reference.slam import Precision, nearest

_F32 = Precision(torch.float32, False)


def pose_gaps(pose: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """Largest position gap (mm) and heading gap (rad, modulo a turn) over
    ``(B, 3)`` poses."""
    d = pose.to(torch.float64) - ref.to(torch.float64)
    xy = torch.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
    th = torch.atan2(torch.sin(d[:, 2]), torch.cos(d[:, 2])).abs()
    return float(xy.max()), float(th.max())


def flag_flips(flags: torch.Tensor, ref: torch.Tensor) -> int:
    return int((flags.cpu().bool() != ref.cpu().bool()).sum())


def _unpartnered(a: torch.Tensor, a_valid: torch.Tensor, b: torch.Tensor, b_valid: torch.Tensor,
                 tol_mm: float) -> torch.Tensor:
    """``(B,)`` counts of valid points of ``a`` with no valid point of ``b``
    within ``tol_mm``."""
    d2, _ = nearest(a.to(torch.float32), b.to(torch.float32), b_valid, _F32)
    return (a_valid & ~(d2 <= tol_mm * tol_mm)).sum(-1)


def map_mismatch(new: torch.Tensor, new_valid: torch.Tensor, ref: torch.Tensor, ref_valid: torch.Tensor,
                 old: torch.Tensor, old_valid: torch.Tensor, tol_mm: float = 1.0) -> tuple[int, int]:
    """Maps ``(B, CAP, 2)`` compared as point sets: ``(points of either map
    with no partner within tol_mm in the other, points of either map new
    against the map before the step)``."""
    bad = _unpartnered(new, new_valid, ref, ref_valid, tol_mm) + _unpartnered(ref, ref_valid, new, new_valid, tol_mm)
    fresh = _unpartnered(new, new_valid, old, old_valid, tol_mm) + _unpartnered(ref, ref_valid, old, old_valid, tol_mm)
    return int(bad.sum()), int(fresh.sum())


def grid_mismatch(new: torch.Tensor, ref: torch.Tensor, old: torch.Tensor, tol: float = 1e-4) -> tuple[int, int]:
    """Grids compared cell by cell: ``(cells where the two differ by more
    than tol, cells the reference's step changed by more than tol)``."""
    new, ref, old = new.to(torch.float64), ref.to(torch.float64), old.to(torch.float64)
    return int(((new - ref).abs() > tol).sum()), int(((ref - old).abs() > tol).sum())


def share(bad: int, of: int) -> float:
    return bad / max(1, of)


def head_gap(prog_levels, ref_levels) -> float:
    """The raw head outputs' root-mean-square gap over the standard deviation
    of the reference's same output, the largest over the box and class
    logits of each level (infinite where the shapes differ)."""
    worst = 0.0
    for (pb, pc), (rb, rc) in zip(prog_levels, ref_levels):
        for p, r in ((pb, rb), (pc, rc)):
            if p.shape != r.shape:
                return float("inf")
            r = r.to(torch.float64)
            rms = torch.sqrt(((p.to(torch.float64) - r) ** 2).mean())
            worst = max(worst, float(rms / torch.clamp(r.std(), min=1e-12)))
    return worst


def box_gaps(dets: list[dict], ref_boxes, ref_conf, strides, threshold: float, margin: float = 0.05) -> list[float]:
    """Decoded boxes compared at the anchors where the reference is clear:
    for each detection whose anchor the reference scores at least
    ``threshold + margin``, the largest gap of a corner (pixels) against
    the reference's box at that anchor, over the anchor's stride."""
    boxes, conf, stride = ref_boxes.double().cpu().numpy(), ref_conf.double().cpu().numpy(), strides.cpu().numpy()
    out = []
    for d, b, c in zip(dets, boxes, conf):
        keep = c[d["anchors"]] >= threshold + margin
        a = d["anchors"][keep]
        out += (abs(d["boxes"][keep] - b[a]).max(1) / stride[a]).tolist()
    return out


def detection_mismatch(dets: list[dict], ref_conf, ref_dets: list[dict], threshold: float, margin: float = 0.05,
                       iou: float = 0.5) -> tuple[int, int]:
    """Detections compared where the reference's decision is clear, per
    image: ``(missed + spurious, strong + detections)``.  A reference
    detection scoring at least ``threshold + margin`` is strong, and missed
    when no detection of its class overlaps it by ``iou``; a detection is
    spurious when the reference scores its anchor below ``threshold -
    margin``.  Decisions within the margin, and the suppression chains
    they start, are left to the head's gap."""
    from portbench.reference.yolo import _iou

    bad = total = 0
    conf = ref_conf.double().cpu().numpy()
    for d, r, c in zip(dets, ref_dets, conf):
        spurious = int((c[d["anchors"]] < threshold - margin).sum())
        strong = r["scores"] >= threshold + margin
        missed = int(strong.sum())
        if strong.any() and len(d["scores"]):
            hit = (_iou(r["boxes"][strong], d["boxes"]) >= iou) & (r["classes"][strong][:, None] == d["classes"][None])
            missed = int((~hit.any(1)).sum())
        bad += missed + spurious
        total += int(strong.sum()) + len(d["scores"])
    return bad, total
