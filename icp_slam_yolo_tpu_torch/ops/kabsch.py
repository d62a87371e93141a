"""Weighted rigid-transform solves (Kabsch).

Counterpart of the JAX package's ``ops/kabsch.py``: ``best_fit_se2``, the
closed-form 2-D solve of each iteration of the general ICP loop
(`core/registration`), and ``best_fit_transform_svd``, the reference's
centroid + SVD solve with its reflection fix in any dimension (API parity
and an oracle; no step of the pipeline calls it).
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


def best_fit_transform_svd(a: torch.Tensor, b: torch.Tensor, weights: torch.Tensor | None = None):
    """Weighted Kabsch in any dimension: ``(N, D)`` points ``a`` onto ``b``.

    ``H = (w (a - ca))^T (b - cb)``, ``R = V U^T``; when ``det(R) < 0`` the
    last row of ``Vt`` is negated (the reflection fix).  Returns ``(R (D,
    D), t (D,))`` with ``b ~= a @ R.T + t``, float32.
    """
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    n, d = a.shape
    w = torch.ones(n, dtype=torch.float32, device=a.device) if weights is None else weights.to(torch.float32)
    wsum = torch.clamp(w.sum(), min=1e-9)
    ca = (a * w[:, None]).sum(0) / wsum
    cb = (b * w[:, None]).sum(0) / wsum
    h = ((a - ca) * w[:, None]).T @ (b - cb)
    u, _, vt = torch.linalg.svd(h)
    r = vt.T @ u.T
    fix = torch.ones(d, dtype=torch.float32, device=a.device)
    fix[-1] = torch.sign(torch.linalg.det(r))
    r = (vt.T * fix[None, :]) @ u.T
    return r, cb - r @ ca
