"""Area attention: the core of YOLO12's ``AAttn`` (Ultralytics
``nn/modules/block.py``), windowed or global, over the output of its
head-grouped ``qkv`` conv.

The map's ``H W`` tokens, in row-major order, are cut into ``area``
contiguous runs (horizontal bands of ``H / area`` rows where ``area``
divides ``H``), and each band attends within itself, head by head:
``softmax(q k^T * hd^-0.5) v``.  ``area=1`` is global attention.  The
channels of ``qkv`` are grouped by head: head ``j`` owns ``[3 hd j, 3 hd
(j + 1))`` as ``q | k | v``, so a head's ``q``, ``k`` and ``v`` are strided
views of the map and nothing is copied to split them.

On a CUDA tensor the products run in ``scaled_dot_product_attention``,
restricted to its fused backends (flash, memory-efficient, cuDNN): the
``(B area heads, T, T)`` scores stay inside the kernel, with float32 softmax
and accumulation, and a shape no fused backend takes raises rather than
falling back to the math backend, which would write them out.  On the CPU
the plain product runs in float32 and is rounded once to the input's type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from icp_slam_yolo_tpu_torch.utils.profiling import span


def check_area(h: int, w: int, area: int) -> int:
    """Tokens of a band; raises where ``area`` does not divide ``h * w``
    (Ultralytics' reshape fails there too: no fall-back to global)."""
    if area < 1 or (h * w) % area:
        raise ValueError(f"area attention: a {h} x {w} map does not split into {area} areas of equal length")
    return h * w // area


def scores(b: int, h: int, w: int, heads: int, area: int) -> int:
    """Query-key pairs scored: ``B * area * heads * T^2``."""
    t = check_area(h, w, area)
    return b * area * heads * t * t


def band_views(qkv: torch.Tensor, heads: int, area: int):
    """``qkv (B, H, W, 3 C)`` -> ``q, k, v``, each ``(B area, heads, T, hd)``,
    strided views of ``qkv``."""
    b, h, w, c3 = qkv.shape
    t = check_area(h, w, area)
    hd = c3 // (3 * heads)
    if hd * 3 * heads != c3:
        raise ValueError(f"area attention: {c3} qkv channels do not split into {heads} heads of q, k and v")
    g = qkv.reshape(b * area, t, heads, 3, hd)
    return tuple(g[:, :, :, i].transpose(1, 2) for i in range(3))


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T * hd^-0.5) v`` in float32, rounded once to ``q``'s type."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def _fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]
    with sdpa_kernel(backends):
        return F.scaled_dot_product_attention(q, k, v, scale=q.shape[-1] ** -0.5)


def area_attention(qkv: torch.Tensor, heads: int, area: int) -> torch.Tensor:
    """``qkv (B, H, W, 3 C)`` NHWC, head-grouped -> the attention's output as
    a map ``(B, H, W, C)`` (channel ``head * hd + d``), in ``qkv``'s type.
    Under the span ``detect.attention`` (band split, products, band merge),
    which counts its ``scores``."""
    b, h, w, c3 = qkv.shape
    with span("detect.attention", own_start=True):
        span.count("scores", scores(b, h, w, heads, area))
        q, k, v = band_views(qkv, heads, area)
        o = _fused(q, k, v) if qkv.is_cuda else plain(q, k, v)
        return o.transpose(1, 2).reshape(b, h, w, c3 // 3)
