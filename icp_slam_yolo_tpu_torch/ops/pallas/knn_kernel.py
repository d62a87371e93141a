"""K9: the statistical outlier filter in one launch: each valid point's mean
distance to its ``k`` nearest other valid points, and the keep-mask ``mean <=
mu + std_ratio * std`` over the cloud.

Replaces no TPU kernel: the JAX package leaves the filter to XLA (a Gram-form
distance matrix and ``approx_max_k`` or ``lax.top_k``, ``ops/nn.py``
``knn_mean_distance``).  The CUDA kernel is ``csrc/knn.cu``, a block of 256
threads a cloud; its source says what bounds it and how it is laid out.

The plain version forms the ``(..., N, N)`` matrix and takes an exact
``torch.topk``.  Its centre, its mean over the k distances and the cloud's
statistics are summed in float64 and rounded once, so their bits do not
depend on the order of the sum; it takes the cross term of the distances
elementwise, with no fused multiply-add, and its square roots through float64
(PyTorch's float32 ``sqrt`` on the CPU is not correctly rounded; the one of
float64 is, and rounds to the correctly rounded float32 root): the kernel,
which does the same, gives its bits.
"""

from __future__ import annotations

import torch

from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.pallas import _lib

_BIG = 1e30
MAX_K = 32  # neighbours a query keeps at most on the card (csrc/knn.cu kMaxK)
MAX_N = 2048  # slots a cloud on the card (csrc/knn.cu kMaxN)


def check_supported(k: int, n: int, device) -> None:
    """Raise where the kernel cannot take ``k`` neighbours of ``n`` slots on
    ``device``; the plain version, on the CPU, takes any."""
    if torch.device(device).type == "cpu":
        return
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_outlier: k {k} outside 1..{MAX_K} on {device}")
    if n > MAX_N:
        raise ValueError(f"knn_outlier: {n} slots, at most {MAX_N} on {device}")


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (``sqrtf`` on the card)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def knn_mean_distance(xy: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of the kernel's first half: mean distance (mm) to the (up
    to) ``k`` nearest *other* valid points, over the real ones where fewer
    exist (0 where none); invalid points get ``1e30``.  Leading batch axes
    are carried through."""
    w = valid.to(torch.float64)
    count = torch.clamp(w.sum(-1), min=1.0)
    center = ((xy.to(torch.float64) * w[..., None]).sum(-2) / count[..., None]).to(torch.float32)
    p = (xy - center[..., None, :]) * 1e-3
    x, y = p[..., 0], p[..., 1]
    sn = x * x + y * y
    cross = x[..., :, None] * x[..., None, :] + y[..., :, None] * y[..., None, :]
    d2 = torch.clamp((sn[..., :, None] + sn[..., None, :]) - 2.0 * cross, min=0.0)
    n = valid.shape[-1]
    self_or_invalid = torch.eye(n, dtype=torch.bool, device=valid.device) | ~valid[..., None, :]
    d2k, _ = torch.topk(d2.masked_fill(self_or_invalid, _BIG), min(k, n), dim=-1, largest=False, sorted=True)
    real = d2k < 1e29
    dk = torch.where(real, _sqrt(d2k) * 1e3, torch.zeros_like(d2k))
    mean_k = (dk.sum(-1, dtype=torch.float64) / torch.clamp(real.sum(-1), min=1)).to(torch.float32)
    return torch.where(valid, mean_k, torch.full_like(mean_k, _BIG))


def knn_outlier_plain(xy: torch.Tensor, valid: torch.Tensor, k: int, std_ratio: float):
    """Plain version: ``(mean k-NN distance (mm), keep-mask)``; a point is
    kept when valid and its mean is at most ``mu + std_ratio * std`` of the
    valid points' means (biased variance, denominators at least 1).  Leading
    batch axes are carried through."""
    mean = knn_mean_distance(xy, valid, k)
    count = torch.clamp(valid.sum(-1, keepdim=True), min=1)
    vals = torch.where(valid, mean, torch.zeros_like(mean))
    mu = (vals.sum(-1, keepdim=True, dtype=torch.float64) / count).to(torch.float32)
    dev = vals - mu
    sq = torch.where(valid, dev * dev, torch.zeros_like(dev))
    var = (sq.sum(-1, keepdim=True, dtype=torch.float64) / count).to(torch.float32)
    return mean, valid & (mean <= mu + std_ratio * _sqrt(var))


def knn_outlier(xy: torch.Tensor, valid: torch.Tensor, k: int, std_ratio: float):
    """``(B, N, 2) f32, (B, N) bool -> ((B, N) f32 mean k-NN distance in mm,
    1e30 where invalid; (B, N) bool keep-mask)``: ``B`` clouds in one launch.

    Launches the CUDA kernel for CUDA tensors, with ``k`` at most `MAX_K` and
    ``N`` at most `MAX_N`; the plain version runs only for CPU tensors, at
    any ``k`` and ``N``.
    """
    dev = xy.device
    b, n = valid.shape[0], valid.shape[-1]
    pallas.check_tensor(xy, "xy", torch.float32, (b, n, 2), dev)
    pallas.check_tensor(valid, "valid", torch.bool, (b, n), dev)
    if k < 1:
        raise ValueError(f"knn_outlier: k {k} below 1")
    if dev.type == "cpu":
        return knn_outlier_plain(xy, valid, k, std_ratio)
    if dev.type != "cuda":
        raise ValueError(f"knn_outlier: unsupported device {dev}")
    check_supported(k, n, dev)
    mean = torch.empty((b, n), dtype=torch.float32, device=dev)
    keep = torch.empty((b, n), dtype=torch.bool, device=dev)
    err = _lib.lib().slam_knn_outlier(
        xy.data_ptr(), valid.data_ptr(), b, n, k, std_ratio, mean.data_ptr(), keep.data_ptr(), _lib.stream_ptr(dev),
    )
    _lib.check(err, "knn_outlier")
    pallas.LAUNCHES["knn_outlier"] += 1
    return mean, keep
