"""Weighted 2-D rigid-transform solve (closed-form Kabsch).

Counterpart of ``best_fit_se2`` in the JAX package's ``ops/kabsch.py``: the
per-iteration solve of the general ICP loop (`core/registration`).
"""

from __future__ import annotations

import torch


def best_fit_se2(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor):
    """Exact minimiser of ``sum_i w_i |R p_i + t - q_i|^2`` in 2-D for
    ``(..., N, 2)`` points and ``(..., N)`` weights.

    Returns ``(theta (...), t (..., 2))``: angles (rad) and translations
    (mm).  Zero total weight returns the identity.
    """
    w = weights.to(torch.float32)
    wsum = w.sum(-1)
    safe = torch.clamp(wsum, min=1e-9)[..., None]
    ca = (src * w[..., None]).sum(-2) / safe
    cb = (dst * w[..., None]).sum(-2) / safe
    # metres for f32 precision of the moment sums
    a = (src - ca[..., None, :]) * 1e-3
    b = (dst - cb[..., None, :]) * 1e-3
    sxx = (w * (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1])).sum(-1)
    sxy = (w * (a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])).sum(-1)
    degenerate = wsum < 1e-6
    theta = torch.where(degenerate, torch.zeros_like(sxx), torch.atan2(sxy, sxx))
    c, s = torch.cos(theta), torch.sin(theta)
    r_ca = torch.stack([c * ca[..., 0] - s * ca[..., 1], s * ca[..., 0] + c * ca[..., 1]], dim=-1)
    t = torch.where(degenerate[..., None], torch.zeros_like(r_ca), cb - r_ca)
    return theta, t
