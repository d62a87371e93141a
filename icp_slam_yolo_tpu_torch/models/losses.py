"""Detection losses: task-aligned assignment + BCE / CIoU / DFL, and the
segment and pose extensions; the counterpart of the JAX package's
``models/losses.py``.

The v8 loss family (box 7.5, cls 0.5, dfl 1.5): the task-aligned assigner
(top-k anchors by ``score^alpha * iou^beta`` among those whose centre lies
inside the ground-truth box), BCE of the classes against the normalised
alignment metric, CIoU on the boxes and distribution-focal loss on the ltrb
bins.  Ground truths are padded to ``max_gt`` a image with a validity mask,
so every shape is static.  The assigner's outputs are targets: it runs
without autograd, as the JAX package stops their gradient.

Inside `parallel.distributed.data_parallel` every reduction over the batch
is over the global batch, as under JAX's ``jit`` with the batch sharded:
the normaliser ``sum(target scores)`` (and so every term divided by it) and
the segment loss's mean over the images.  Each rank's loss is then its
share of the global loss, and the sum of the ranks' gradients is the
global gradient.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from icp_slam_yolo_tpu_torch.models.yolo import decode_keypoints, dfl_decode, make_anchors
from icp_slam_yolo_tpu_torch.parallel import distributed


class LossWeights(NamedTuple):
    box: float = 7.5
    cls: float = 0.5
    dfl: float = 1.5


def ciou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU between aligned xyxy boxes ``(..., 4)``; the aspect
    term's weight ``alpha`` carries no gradient."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)
    union = area_a + area_b - inter
    iou = inter / (union + eps)

    # the enclosing box's diagonal and the centres' distance
    elt = torch.minimum(a[..., :2], b[..., :2])
    erb = torch.maximum(a[..., 2:], b[..., 2:])
    ewh = erb - elt
    c2 = ewh[..., 0] ** 2 + ewh[..., 1] ** 2 + eps
    ca = (a[..., :2] + a[..., 2:]) / 2
    cb = (b[..., :2] + b[..., 2:]) / 2
    rho2 = torch.sum((ca - cb) ** 2, dim=-1)

    wa = torch.clamp(a[..., 2] - a[..., 0], min=eps)
    ha = torch.clamp(a[..., 3] - a[..., 1], min=eps)
    wb = torch.clamp(b[..., 2] - b[..., 0], min=eps)
    hb = torch.clamp(b[..., 3] - b[..., 1], min=eps)
    v = (4 / math.pi**2) * (torch.atan(wb / hb) - torch.atan(wa / ha)) ** 2
    alpha = v / (v - iou + 1 + eps)
    return iou - rho2 / c2 - alpha.detach() * v


@torch.no_grad()
def task_aligned_assign(pred_scores, pred_boxes, anchors, gt_boxes, gt_classes, gt_valid,
                        topk: int = 10, alpha: float = 0.5, beta: float = 6.0):
    """Batched over images: ``pred_scores (B, A, C)`` sigmoid probabilities,
    ``pred_boxes (B, A, 4)`` decoded xyxy, ``anchors (A, 2)``, ``gt_boxes (B,
    M, 4)``, ``gt_classes (B, M)``, ``gt_valid (B, M)``.  Returns
    ``(assigned_gt (B, A), fg_mask (B, A), target_scores (B, A, C))``; an
    anchor claimed by several ground truths goes to the highest metric, the
    first on a tie."""
    bsz, a, n_cls = pred_scores.shape
    m = gt_boxes.shape[1]
    ax, ay = anchors[None, None, :, 0], anchors[None, None, :, 1]
    inside = ((ax > gt_boxes[..., 0, None]) & (ax < gt_boxes[..., 2, None])
              & (ay > gt_boxes[..., 1, None]) & (ay < gt_boxes[..., 3, None])) & gt_valid[..., None]  # (B, M, A)

    cls_idx = gt_classes.long()
    cls_score = torch.gather(pred_scores.transpose(1, 2), 1, cls_idx[..., None].expand(bsz, m, a))  # (B, M, A)
    overlap = ciou(gt_boxes[:, :, None, :].expand(bsz, m, a, 4), pred_boxes[:, None].expand(bsz, m, a, 4))
    overlap = torch.clamp(overlap, 0.0, 1.0)
    metric = (cls_score ** alpha) * (overlap ** beta)
    metric = torch.where(inside, metric, 0.0)

    k = min(topk, a)
    thresh = torch.topk(metric, k, dim=-1).values[..., -1:]  # the k-th best: its ties' order does not matter
    candidate = inside & (metric >= torch.clamp(thresh, min=1e-9)) & (metric > 0)

    masked = torch.where(candidate, metric, -1.0)
    best, assigned_gt = masked.max(dim=1)  # first index on ties, as jnp.argmax
    fg_mask = best > 0

    pos_metric = torch.where(candidate, metric, 0.0).amax(dim=2, keepdim=True)  # (B, M, 1)
    pos_overlap = torch.where(candidate, overlap, 0.0).amax(dim=2, keepdim=True)
    norm_metric = metric * pos_overlap / torch.clamp(pos_metric, min=1e-9)
    score = torch.gather(norm_metric, 1, assigned_gt[:, None, :])[:, 0]  # (B, A)
    cls_of = torch.gather(cls_idx, 1, assigned_gt)
    target_scores = F.one_hot(cls_of, n_cls).float() * torch.where(fg_mask, score, 0.0)[..., None]
    return assigned_gt.to(torch.int32), fg_mask, target_scores


def _flat(outs, branch: int, width: int | None = None) -> torch.Tensor:
    """One branch of the per-level head outputs ``(B, H, W, E)`` as float32
    rows ``(B, A, E)``."""
    return torch.cat([o[branch].reshape(o[branch].shape[0], -1, width or o[branch].shape[-1]) for o in outs],
                     dim=1).float()


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t (B, M, ...)`` rows by ``idx (B, A)`` -> ``(B, A, ...)``."""
    tail = t.shape[2:]
    flat_idx = idx.long().reshape(*idx.shape, *([1] * len(tail))).expand(*idx.shape, *tail)
    return torch.gather(t, 1, flat_idx)


def detection_loss(outs, gt_boxes, gt_classes, gt_valid, img_size: int, num_classes: int, reg_max: int = 16,
                   weights: LossWeights = LossWeights(), gt_angles=None, angle_weight: float = 1.0,
                   return_aux: bool = False):
    """Total loss (a scalar tensor) and a dict of metric tensors for a batch
    of head outputs.  ``gt_boxes (B, M, 4)`` xyxy pixels, ``gt_classes (B,
    M)``, ``gt_valid (B, M)``.  With ``gt_angles (B, M)`` (radians) and an
    OBB head, the angle branch (decoded as at inference, into (-pi/4,
    3pi/4)) gets a smooth-L1 term on the foreground anchors against the
    assigned angle, its error wrapped pi-periodically."""
    dev = outs[0][0].device
    anchors, strides = make_anchors(img_size, device=dev)

    box_l = _flat(outs, 0, 4 * reg_max)  # (B, A, 64)
    cls_l = _flat(outs, 1, num_classes)  # (B, A, C)

    ltrb = dfl_decode(box_l, reg_max)  # (B, A, 4) in stride units
    xy1 = anchors[None] - ltrb[..., :2] * strides[None, :, None]
    xy2 = anchors[None] + ltrb[..., 2:] * strides[None, :, None]
    pred_boxes = torch.cat([xy1, xy2], dim=-1)
    pred_scores = torch.sigmoid(cls_l)

    assigned_gt, fg, tgt_scores = task_aligned_assign(pred_scores.detach(), pred_boxes.detach(), anchors,
                                                      gt_boxes, gt_classes, gt_valid)

    # the representability gate: an anchor whose assigned box needs an ltrb
    # distance beyond reg_max - 1 bins cannot express it; it leaves the
    # foreground so that coarser-stride anchors carry the object
    tgt_boxes = _take(gt_boxes, assigned_gt)  # (B, A, 4)
    raw_ltrb = torch.cat([(anchors[None] - tgt_boxes[..., :2]) / strides[None, :, None],
                          (tgt_boxes[..., 2:] - anchors[None]) / strides[None, :, None]], dim=-1)
    representable = torch.all(raw_ltrb < reg_max - 1.01, dim=-1)
    fg = fg & representable
    tgt_scores = tgt_scores * fg[..., None]

    norm = torch.clamp(distributed.global_sum(torch.sum(tgt_scores)), min=1.0)

    # classification: BCE against the soft target scores over every anchor
    bce = -(tgt_scores * F.logsigmoid(cls_l) + (1 - tgt_scores) * F.logsigmoid(-cls_l))
    loss_cls = torch.sum(bce) / norm

    # box: CIoU on the foreground anchors, weighted by the target score
    w_fg = torch.sum(tgt_scores, dim=-1) * fg  # (B, A)
    iou_term = 1.0 - ciou(pred_boxes, tgt_boxes)
    loss_box = torch.sum(iou_term * w_fg) / norm

    # DFL: cross-entropy against the two integer bins around the target ltrb
    tgt_ltrb = torch.clamp(raw_ltrb, 0, reg_max - 1 - 0.01)
    tl = torch.floor(tgt_ltrb)
    wr = tgt_ltrb - tl
    logp = F.log_softmax(box_l.reshape(*box_l.shape[:-1], 4, reg_max), dim=-1)
    tl_i = tl.long()
    lp_l = torch.gather(logp, -1, tl_i[..., None])[..., 0]
    lp_r = torch.gather(logp, -1, torch.clamp(tl_i + 1, max=reg_max - 1)[..., None])[..., 0]
    dfl = -(lp_l * (1 - wr) + lp_r * wr)  # (B, A, 4)
    loss_dfl = torch.sum(torch.mean(dfl, dim=-1) * w_fg) / norm

    total = weights.box * loss_box + weights.cls * loss_cls + weights.dfl * loss_dfl
    metrics = {"loss_box": loss_box, "loss_cls": loss_cls, "loss_dfl": loss_dfl, "num_fg": torch.sum(fg)}

    if gt_angles is not None and len(outs[0]) == 3:
        ang_l = torch.cat([o[2].reshape(o[2].shape[0], -1) for o in outs], dim=1).float()  # (B, A)
        pred_ang = (torch.sigmoid(ang_l) - 0.25) * math.pi  # the inference decode
        tgt_ang = torch.gather(gt_angles, 1, assigned_gt.long())
        # a rectangle's orientation is pi-periodic: the error wrapped into
        # (-pi/2, pi/2] so that equivalent orientations cost nothing
        raw = pred_ang - tgt_ang
        diff = torch.atan2(torch.sin(2.0 * raw), torch.cos(2.0 * raw)) * 0.5
        huber = torch.where(torch.abs(diff) < 1.0, 0.5 * diff * diff, torch.abs(diff) - 0.5)
        loss_ang = torch.sum(huber * w_fg) / norm
        total = total + angle_weight * loss_ang
        metrics["loss_angle"] = loss_ang

    metrics["loss"] = total
    if return_aux:
        return total, metrics, {"assigned_gt": assigned_gt, "fg": fg, "w_fg": w_fg, "norm": norm}
    return total, metrics


def _batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of per-image values ``x (B,)``; inside `data_parallel`,
    this rank's share of the mean over the global batch (every rank holds
    ``B`` images)."""
    group = distributed.data_parallel_group()
    if group is None:
        return torch.mean(x)
    return torch.sum(x) / (x.shape[0] * torch.distributed.get_world_size(group))


def top_k_stable(x: torch.Tensor, k: int):
    """``lax.top_k`` on the last axis: the ``k`` largest values, descending,
    equal values in index order (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def optax_sigmoid_bce(logits, labels):
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))


def segmentation_loss(outs, protos, gt_boxes, gt_classes, gt_valid, gt_masks, img_size: int, num_classes: int,
                      reg_max: int = 16, weights: LossWeights = LossWeights(), max_fg: int = 64,
                      mask_weight: float = 2.0):
    """Detection loss + a per-instance mask loss (v8-seg): for the top
    ``max_fg`` foreground anchors of each image by assignment weight,
    ``sigmoid(protos @ coeffs)`` cropped to the assigned box against the
    ground-truth mask ``gt_masks (B, M, Hp, Wp)``, BCE normalised by the
    box's area."""
    det_total, metrics, aux = detection_loss(outs, gt_boxes, gt_classes, gt_valid, img_size, num_classes, reg_max,
                                             weights, return_aux=True)
    coef_l = _flat(outs, 2)  # (B, A, P)
    bsz, hp, wp, _ = protos.shape
    scale = hp / img_size

    w_top, idx = top_k_stable(aux["w_fg"], max_fg)  # (B, K)
    sel_gt = torch.gather(aux["assigned_gt"].long(), 1, idx)  # (B, K)
    c = _take(coef_l, idx)  # (B, K, P)
    logits = torch.einsum("bhwp,bkp->bkhw", protos.float(), c)  # (B, K, Hp, Wp)
    tgt = _take(gt_masks, sel_gt)  # (B, K, Hp, Wp)
    box = _take(gt_boxes, sel_gt) * scale  # (B, K, 4) proto pixels
    ys = torch.arange(hp, dtype=torch.float32, device=protos.device)[None, None, :, None]
    xs = torch.arange(wp, dtype=torch.float32, device=protos.device)[None, None, None, :]
    inside = ((xs >= box[..., 0, None, None]) & (xs < box[..., 2, None, None])
              & (ys >= box[..., 1, None, None]) & (ys < box[..., 3, None, None])).float()
    bce = optax_sigmoid_bce(logits, tgt) * inside
    area = torch.clamp((box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1]), min=1.0)
    per_inst = torch.sum(bce, dim=(2, 3)) / area  # (B, K)
    w = (w_top > 0).float()
    loss_mask = _batch_mean(torch.sum(per_inst * w, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1.0))
    total = det_total + mask_weight * loss_mask
    return total, dict(metrics, loss_mask=loss_mask, loss=total)


def pose_loss(outs, gt_boxes, gt_classes, gt_valid, gt_kpts, img_size: int, num_classes: int, reg_max: int = 16,
              weights: LossWeights = LossWeights(), kpt_weight: float = 12.0, kobj_weight: float = 1.0):
    """Detection loss + the OKS keypoint-location loss + the visibility BCE
    (v8-pose).  ``gt_kpts (B, M, K, 3)``: ``[x_px, y_px, visible 0/1]``.
    The location term of a foreground anchor is ``1 - exp(-d2 / (2 * area *
    (2s)^2))`` with ``s = 1/K`` and ``area`` the assigned box's, averaged
    over the visible keypoints and weighted by the assignment score."""
    det_total, metrics, aux = detection_loss(outs, gt_boxes, gt_classes, gt_valid, img_size, num_classes, reg_max,
                                             weights, return_aux=True)
    anchors, strides = make_anchors(img_size, device=outs[0][0].device)
    kpt_l = _flat(outs, 2)  # (B, A, K*3)
    pred = decode_keypoints(kpt_l, anchors, strides)  # (B, A, K, 3)
    vis_logit = kpt_l.reshape(*pred.shape)[..., 2]

    assigned, w_fg, norm = aux["assigned_gt"], aux["w_fg"], aux["norm"]
    tgt = _take(gt_kpts, assigned)  # (B, A, K, 3)
    tgt_boxes = _take(gt_boxes, assigned)
    area = torch.clamp((tgt_boxes[..., 2] - tgt_boxes[..., 0]) * (tgt_boxes[..., 3] - tgt_boxes[..., 1]), min=1.0)

    k = pred.shape[-2]
    sigma = 1.0 / k
    kpt_mask = (tgt[..., 2] > 0).float()  # (B, A, K)
    d2 = torch.sum((pred[..., :2] - tgt[..., :2]) ** 2, dim=-1)
    e = d2 / (2.0 * area[..., None] * (2.0 * sigma) ** 2 + 1e-9)
    oks_term = (1.0 - torch.exp(-e)) * kpt_mask
    per_anchor = torch.sum(oks_term, dim=-1) / torch.clamp(torch.sum(kpt_mask, dim=-1), min=1.0)
    loss_kpt = torch.sum(per_anchor * w_fg) / norm

    bce_v = optax_sigmoid_bce(vis_logit, kpt_mask)
    loss_kobj = torch.sum(torch.mean(bce_v, dim=-1) * w_fg) / norm

    total = det_total + kpt_weight * loss_kpt + kobj_weight * loss_kobj
    return total, dict(metrics, loss_kpt=loss_kpt, loss_kobj=loss_kobj, loss=total)
