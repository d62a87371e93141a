"""K3: nearest valid target per source point, ``(min d², argmin)``.

Counterpart of the JAX package's ``nn_argmin_pallas``
(``ops/pallas/nn_kernel.py``).  The CUDA kernel is ``csrc/nn.cu``; its source
says what bounds it and how it is laid out.  `nn_plan` picks its layout of
`layouts` from the shape; every layout gives the same bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.pallas import _lib

_BIG = 1e30
LANES = (4, 16)  # source lanes a warp: a block owns 4 * lanes source points
CLUSTERS = (1, 2, 4, 8)
MIN_SLICE = 2048  # targets a cluster rank keeps at least: below that a split only adds a merge


class NnPlan(NamedTuple):
    lanes: int    # source lanes a warp: a block owns 4 * lanes source points
    cluster: int  # blocks of a cluster that split the targets


def layouts(b: int, s: int, t: int, sms: int) -> tuple[NnPlan, ...]:
    """Every layout of a shape (`nn_plan`'s arguments): each source tile with
    each cluster; all fit every shape."""
    return tuple(NnPlan(lanes, cluster) for lanes in LANES for cluster in CLUSTERS)


@functools.lru_cache(maxsize=None)
def nn_plan(b: int, s: int, t: int, sms: int) -> NnPlan:
    """The layout of `layouts` that the kernel launches.

    The large source tile (64 points a block) where it alone gives every
    multiprocessor a block; otherwise the small one (16), and the targets
    split over a cluster of up to 8 blocks while the grid is below one block
    a multiprocessor and each block keeps at least `MIN_SLICE` targets.  So
    the step's 512 x 512 (one problem or eight) is never split, and the
    rescue's 512 x 24576 is split 8 ways.
    """
    if b * -(-s // 64) >= sms:
        return NnPlan(16, 1)
    blocks = b * -(-s // 16)
    return next(p for p in layouts(b, s, t, sms) if p.lanes == 4 and (
        p.cluster == CLUSTERS[-1] or blocks * p.cluster >= sms or t // (2 * p.cluster) < MIN_SLICE))


def nn_argmin_plain(src_xy: torch.Tensor, tgt_xy: torch.Tensor, tgt_valid: torch.Tensor):
    """Plain version: difference-form d², invalid targets excluded, first
    index on ties; ``(1e30, 0)`` when no target is valid.  Leading batch axes
    are carried through."""
    dx = src_xy[..., :, None, 0] - tgt_xy[..., None, :, 0]
    dy = src_xy[..., :, None, 1] - tgt_xy[..., None, :, 1]
    d2 = dx * dx + dy * dy
    d2 = torch.where(tgt_valid[..., None, :], d2, torch.full_like(d2, _BIG))
    idx = torch.argmin(d2, dim=-1)  # first occurrence of the minimum
    return torch.gather(d2, -1, idx[..., None])[..., 0], idx.to(torch.int32)


def nn_argmin(src_xy: torch.Tensor, tgt_xy: torch.Tensor, tgt_valid: torch.Tensor, *,
              plan: NnPlan | None = None):
    """``(B, S, 2) f32, (B, T, 2) f32, (B, T) bool -> ((B, S) f32 d², (B, S)
    int32)``: ``B`` independent problems in one launch.

    Launches the CUDA kernel for CUDA tensors, in ``plan`` (one of
    `layouts`; ``None``: `nn_plan`'s); the plain version runs only for CPU
    tensors.
    """
    dev = src_xy.device
    b, s, t = src_xy.shape[0], src_xy.shape[1], tgt_xy.shape[-2]
    pallas.check_tensor(src_xy, "src_xy", torch.float32, (b, s, 2), dev)
    pallas.check_tensor(tgt_xy, "tgt_xy", torch.float32, (b, t, 2), dev)
    pallas.check_tensor(tgt_valid, "tgt_valid", torch.bool, (b, t), dev)
    if dev.type == "cpu":
        return nn_argmin_plain(src_xy, tgt_xy, tgt_valid)
    if dev.type != "cuda":
        raise ValueError(f"nn_argmin: unsupported device {dev}")
    plan = pallas.chosen("nn_argmin", plan, nn_plan, layouts, b, s, t, _lib.sm_count(dev))
    d2 = torch.empty((b, s), dtype=torch.float32, device=dev)
    idx = torch.empty((b, s), dtype=torch.int32, device=dev)
    err = _lib.lib().slam_nn_argmin(
        src_xy.data_ptr(), tgt_xy.data_ptr(), tgt_valid.data_ptr(), b, s, t, plan.lanes, plan.cluster,
        d2.data_ptr(), idx.data_ptr(), _lib.stream_ptr(dev),
    )
    _lib.check(err, "nn_argmin")
    pallas.LAUNCHES["nn_argmin"] += 1
    return d2, idx
