"""Masked brute-force nearest neighbour, k-NN and local covariances.

Counterpart of the JAX package's ``ops/nn.py``.  ``nearest_neighbor`` always
goes through K3 (`ops/pallas/nn_kernel.nn_argmin`): the CUDA kernel on the
card, its plain version on the CPU.  The k-NN functions are plain products
and an exact ``torch.topk`` (the JAX package's approximate top-k is a
TPU-only path); like there they centre on the masked mean and rescale to
metres before the Gram-form product, which keeps squared distances O(100)
in float32.  The mean k-NN distance of the outlier filter is K9
(`ops/pallas/knn_kernel`), which forms no distance matrix on the card.

The k-NN functions take leading batch axes (the fleet's robot axis): clouds
are ``(..., N, 2)`` with masks ``(..., N)``; ``nearest_neighbor`` takes K3's
``(B, N, 2)``.
"""

from __future__ import annotations

import torch

from icp_slam_yolo_tpu_torch.ops.geometry import masked_mean
from icp_slam_yolo_tpu_torch.ops.pallas.nn_kernel import nn_argmin

_BIG = 1e30


def nearest_neighbor(
    src_xy: torch.Tensor,
    tgt_xy: torch.Tensor,
    tgt_valid: torch.Tensor,
    src_valid: torch.Tensor | None = None,
):
    """Nearest valid target for every source point.

    ``(B, N, 2), (B, M, 2), (B, M)[, (B, N)]`` -> ``(dist_mm (B, N) f32, idx
    (B, N) int32)``; invalid sources get distance ``1e30``.
    """
    d2, idx = nn_argmin(src_xy, tgt_xy, tgt_valid)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    if src_valid is not None:
        dist = torch.where(src_valid, dist, torch.full_like(dist, _BIG))
    return dist, idx


def pairwise_sqdist(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """``(..., N, M)`` squared distances in the units of the inputs (Gram
    form, full float32: TF32 stays off package-wide)."""
    sn = (src * src).sum(-1)
    tn = (tgt * tgt).sum(-1)
    cross = src @ tgt.transpose(-1, -2)
    return torch.clamp(sn[..., :, None] + tn[..., None, :] - 2.0 * cross, min=0.0)


def _smallest_k(d2: torch.Tensor, k: int):
    """``(values, idx)`` of the ``k`` smallest entries per row, ascending."""
    return torch.topk(d2, k, dim=-1, largest=False, sorted=True)


def _metres(xy: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    return (xy - center[..., None, :]) * 1e-3


def _self_or_invalid(valid: torch.Tensor) -> torch.Tensor:
    """``(..., N, N)`` mask of the pairs a point may not take as neighbour:
    itself and invalid points."""
    n = valid.shape[-1]
    return torch.eye(n, dtype=torch.bool, device=valid.device) | ~valid[..., None, :]


def knn_indices(xy: torch.Tensor, valid: torch.Tensor, k: int):
    """Indices of the (up to) ``k`` nearest *other* valid points for every
    point: ``(idx (..., M, k) int32, ok (..., M, k) bool)``, ``ok`` marking
    real (valid, non-self) neighbours.  The whole ``(M, M)`` distance matrix
    is formed at once: callers pass scan-sized clouds."""
    k = min(k, xy.shape[-2])
    p = _metres(xy, masked_mean(xy, valid))
    d2 = pairwise_sqdist(p, p).masked_fill(_self_or_invalid(valid), _BIG)
    vals, idx = _smallest_k(d2, k)
    return idx.to(torch.int32), vals < 1e29


def _regularized_cov(pts: torch.Tensor, w: torch.Tensor, epsilon: float, extra_degenerate=None):
    """Neighbourhoods ``(..., N, K, 2)`` with weights ``(..., N, K)`` ->
    Segal-regularised ``(..., N, 2, 2)`` covariances: eigenvalues replaced by
    ``(1, eps_eff)`` so only the principal (wall-tangent) direction survives,
    ``C = eps I + (1 - eps) u u^T``, with the planarity gating of the JAX
    package (``eps_eff`` rises to 1 as the neighbourhood loses linearity).
    Degenerate neighbourhoods (fewer than 3 real members, or isotropic) get
    the identity."""
    wsum = w.sum(-1)
    n = torch.clamp(wsum, min=1.0)[..., None, None]
    mu = (pts * w[..., None]).sum(-2, keepdim=True) / n
    d = (pts - mu) * 1e-3 * w[..., None]
    a = (d[..., 0] * d[..., 0]).sum(-1)
    b = (d[..., 0] * d[..., 1]).sum(-1)
    c = (d[..., 1] * d[..., 1]).sum(-1)
    disc = torch.sqrt(torch.clamp(((a - c) * 0.5) ** 2 + b * b, min=0.0))
    e1 = (a + c) * 0.5 + disc
    # principal eigenvector: the better-conditioned of the two analytic forms
    v1 = torch.stack([b, e1 - a], dim=-1)
    v2 = torch.stack([e1 - c, b], dim=-1)
    n1 = (v1 * v1).sum(-1)
    n2 = (v2 * v2).sum(-1)
    v = torch.where((n1 > n2)[..., None], v1, v2)
    vn = torch.clamp(torch.sqrt(torch.maximum(n1, n2)), min=1e-20)
    u = v / vn[..., None]
    e2 = (a + c) * 0.5 - disc
    lin = (e1 - e2) / torch.clamp(e1, min=1e-20)  # 1 = perfect line, 0 = isotropic
    eps_eff = (epsilon + (1.0 - lin * lin) * (1.0 - epsilon))[..., None, None]
    eye = torch.eye(2, dtype=torch.float32, device=pts.device)
    cov = eps_eff * eye + (1.0 - eps_eff) * (u[..., :, None] * u[..., None, :])
    degenerate = (wsum < 3.0) | (disc < 1e-14)
    if extra_degenerate is not None:
        degenerate = degenerate | extra_degenerate
    return torch.where(degenerate[..., None, None], eye, cov)


def _take(cloud: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``cloud (..., M, 2)`` at ``idx (..., N, K)`` -> ``(..., N, K, 2)``."""
    flat = idx.reshape(*idx.shape[:-2], -1).long()
    out = torch.gather(cloud, -2, flat[..., None].expand(*flat.shape, 2))
    return out.reshape(*idx.shape, 2)


def local_covariances(xy: torch.Tensor, valid: torch.Tensor, k: int = 20,
                      epsilon: float = 1e-3) -> torch.Tensor:
    """GICP-regularised local covariance per point, ``(..., M, 2, 2)``, from
    the point itself and its ``k`` nearest valid neighbours."""
    idx, ok = knn_indices(xy, valid, k)
    pts = torch.cat([xy[..., :, None, :], _take(xy, idx)], dim=-2)
    w = torch.cat([valid[..., :, None], ok], dim=-1).to(torch.float32)
    return _regularized_cov(pts, w, epsilon, extra_degenerate=~valid)


def local_covariances_at(queries: torch.Tensor, cloud: torch.Tensor, cloud_valid: torch.Tensor,
                         k: int = 20, epsilon: float = 1e-3) -> torch.Tensor:
    """Segal-regularised covariance of each query's k-NN neighbourhood in
    ``cloud``: ``(..., N, 2, 2)``.  One ``(N, M)`` distance slab; a query that
    is itself a cloud point finds itself as its own nearest neighbour."""
    center = masked_mean(cloud, cloud_valid)
    d2 = pairwise_sqdist(_metres(queries, center), _metres(cloud, center))
    d2 = d2.masked_fill(~cloud_valid[..., None, :], _BIG)
    vals, idx = _smallest_k(d2, min(k, cloud.shape[-2]))
    return _regularized_cov(_take(cloud, idx), (vals < 1e29).to(torch.float32), epsilon)
