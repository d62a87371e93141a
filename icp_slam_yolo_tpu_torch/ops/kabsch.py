"""Weighted 2-D rigid-transform solve (closed-form Kabsch).

Counterpart of ``best_fit_se2`` in the JAX package's ``ops/kabsch.py``: the
per-iteration solve of a non-fused ICP, kept as a leaf op for the GICP slice.
"""

from __future__ import annotations

import torch


def best_fit_se2(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor):
    """Exact minimiser of ``sum_i w_i |R p_i + t - q_i|^2`` in 2-D.

    Returns ``(theta, t)``: a 0-d angle (rad) and a ``(2,)`` translation
    (mm).  Zero total weight returns the identity.
    """
    w = weights.to(torch.float32)
    wsum = w.sum()
    safe = torch.clamp(wsum, min=1e-9)
    ca = (src * w[:, None]).sum(0) / safe
    cb = (dst * w[:, None]).sum(0) / safe
    # metres for f32 precision of the moment sums
    a = (src - ca) * 1e-3
    b = (dst - cb) * 1e-3
    sxx = (w * (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1])).sum()
    sxy = (w * (a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])).sum()
    degenerate = wsum < 1e-6
    zero = torch.zeros((), dtype=torch.float32, device=src.device)
    theta = torch.where(degenerate, zero, torch.atan2(sxy, sxx))
    c, s = torch.cos(theta), torch.sin(theta)
    r_ca = torch.stack([c * ca[0] - s * ca[1], s * ca[0] + c * ca[1]])
    t = torch.where(degenerate, torch.zeros_like(r_ca), cb - r_ca)
    return theta, t
