"""Non-maximum suppression with static shapes, batched.

The counterpart of the JAX package's ``ops/nms.py``.  Every function takes a
leading batch axis written out (the JAX package maps one image's function
over the batch): boxes ``(B, K, 4)``, scores ``(B, K)`` and so on.

Greedy suppression over score-sorted candidates is the unique fixpoint of the
lower-triangular relation ``keep_i = valid_i AND no kept j < i suppresses i``;
iterating the whole-vector equation from ``keep = valid`` fixes every index
whose suppression chain is at most t long after t rounds, so K rounds always
suffice and 1-3 are typical.  On the card, asking whether a round changed
anything is a host read.  `suppress` therefore runs rounds in groups of
``ROUNDS_PER_CHECK`` and reads once per group: the result is the exact
fixpoint (a round at the fixpoint changes nothing), at one host read per call
for the usual chains.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icp_slam_yolo_tpu_torch.utils.profiling import span

ROUNDS_PER_CHECK = 4


class Detections(NamedTuple):
    boxes: torch.Tensor       # (B, K, 4) xyxy pixels
    scores: torch.Tensor      # (B, K)
    classes: torch.Tensor     # (B, K) int32
    valid: torch.Tensor       # (B, K) bool
    anchor_idx: torch.Tensor  # (B, K) int32 index into the flat anchor axis; -1 where invalid


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: ``(..., N, 4) x (..., M, 4) -> (..., N, M)``."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def _top_k(scores: torch.Tensor, k: int):
    """The ``k`` largest per row, ties to the lower index (a stable sort)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(scores, -1, order), order


def nms(boxes, scores, classes, conf_threshold: float = 0.5, iou_threshold: float = 0.45,
        max_detections: int = 100) -> Detections:
    """Greedy class-aware NMS over flat per-anchor candidates: ``boxes (B, A,
    4)`` xyxy, ``scores (B, A)`` best-class confidence, ``classes (B, A)``.
    Returns the top ``max_detections`` survivors, score-sorted, with a valid
    mask."""
    k = min(max_detections, boxes.shape[-2])
    cand = torch.where(scores >= conf_threshold, scores, torch.full_like(scores, -1.0))
    top_scores, top_idx = _top_k(cand, k)
    top_boxes = torch.gather(boxes, -2, top_idx[..., None].expand(*top_idx.shape, 4))
    top_classes = torch.gather(classes, -1, top_idx)
    return suppress(top_boxes, top_scores, top_classes, top_idx.to(torch.int32), top_scores > 0, iou_threshold)


def suppress(top_boxes, top_scores, top_classes, top_idx, cand_valid, iou_threshold: float = 0.45) -> Detections:
    """Greedy suppression over score-descending candidates ``(B, K, ...)``
    (row 0 of an image is its best score); rows that are no candidates have
    ``cand_valid`` false.  Exact: see the module docstring.  Adds the
    rounds run and the host reads made to the enclosing span's ``rounds``
    and ``reads`` counts (`utils/profiling.span.count`)."""
    k = top_scores.shape[-1]
    iou = box_iou(top_boxes, top_boxes)
    same_class = top_classes[..., :, None] == top_classes[..., None, :]
    order = torch.arange(k, device=top_scores.device)
    # sup[.., j, i]: an earlier (higher-score) kept j removes i
    sup = (iou > iou_threshold) & same_class & (order[:, None] < order[None, :])
    keep = cand_valid
    rounds = reads = 0
    while rounds < k:
        for _ in range(min(ROUNDS_PER_CHECK, k - rounds)):
            prev = keep
            keep = cand_valid & ~(prev[..., :, None] & sup).any(dim=-2)
            rounds += 1
        reads += 1
        if torch.equal(keep, prev):  # the one host read per group of rounds
            break
    span.count("rounds", rounds)
    span.count("reads", reads)
    zero = torch.zeros((), dtype=top_boxes.dtype, device=top_boxes.device)
    return Detections(
        boxes=torch.where(keep[..., None], top_boxes, zero),
        scores=torch.where(keep, top_scores, zero.to(top_scores.dtype)),
        classes=torch.where(keep, top_classes, torch.full_like(top_classes, -1)),
        valid=keep,
        anchor_idx=torch.where(keep, top_idx, torch.full_like(top_idx, -1)),
    )


def best_class(scores_ac: torch.Tensor):
    """Per-anchor best class and confidence from ``(..., A, C)`` class scores
    (the first class on ties)."""
    conf, cls = scores_ac.max(dim=-1)
    return conf, cls.to(torch.int32)
