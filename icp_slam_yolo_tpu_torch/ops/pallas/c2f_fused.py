"""K8: the whole v8 ``C2f(n=1)`` block in one kernel.

Counterpart of the JAX package's ``c2f_fused`` (``ops/pallas/c2f_fused.py``).
The CUDA kernel is ``csrc/c2f.cu``; its source says what bounds it and how it
is laid out.  `c2f_plan` picks its layout of `layouts` from the shape: the
block's output tile, how many blocks of a cluster share it, and the gather
(16-byte copies or scalar loads).  The JAX kernel's weight arrangement
(`arrange_c2f_weights`, the permuted and banded matrices) is a layout
workaround of its target and is not carried over: the kernel takes the
folded weights as they are.

Rounding points, as in the JAX kernel: ``a`` and ``b`` (the halves of
``silu(cv1(x))``) and ``t1`` are rounded to the working type; ``t2`` is not:
``p = float32(b) + t2`` is summed in float32 and then rounded.  The zero
padding of the two 3x3s is of the intermediates ``b`` and ``t1``, not of
``x``.  The four biases are float32, as the JAX serving path keeps them (the
single-conv kernels K5-K7 round theirs to the working type instead).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.pallas import _lib, conv_fused

_TYPES = (torch.bfloat16, torch.float32)
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may ask for on sm_90
TILES = (8, 4, 2)  # output pixels a side of a block's tile
CLUSTERS = (1, 2, 4)  # blocks of a cluster that share one tile (bfloat16)
RING, BK, A_ROW = 3, 32, 40  # stages of the x and W rings, K values a chunk, staged x row
BK_VEC = 64  # K values a chunk of stages 2-4 with the 16-byte copies (A read in place)


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _odd_row(n: int) -> int:
    """A shared pixel row of ``n`` values grown to an odd number of 16-byte units."""
    return ((n // 8) | 1) * 8


def width(c: int, cluster: int) -> int:
    """The bfloat16 kernel's pass width: its share of t1's channels rounded
    up to 16, 32 or 64 (``c2f_width`` in c2f.cu)."""
    share = _round8(c) // cluster
    return 16 if share <= 16 else 32 if share <= 32 else 64


def wide(bn: int) -> int:
    """The pass width of stages 1 and 4 (``c2f_wide``): twice `width`, at most 64."""
    return 64 if bn >= 32 else 32


def smem_bytes(c: int, tile: int, cluster: int, bf16: bool, vec: bool) -> int:
    """Dynamic shared memory of one block (``slam_c2f_smem_bytes`` in c2f.cu);
    ``vec``: the 16-byte copies, whose W ring holds chunks of `BK_VEC` rows."""
    p1, p2, p3 = (tile + 4) ** 2, (tile + 2) ** 2, tile ** 2
    if not bf16:
        bn = 16 if c <= 16 else 32 if c <= 32 else 64
        return 4 * (BK * bn + (4096 // bn) * (BK + 1)) + 8 * p1 + 4 * (p1 * 2 * c + p2 * c + p3 * c)
    cp, ma = _round8(c), -(-p1 // 16) * 16
    ys, ts = _odd_row(2 * cp), _odd_row(cp)
    # x's ring (stage 1 only) overlays t1 and p
    w_rows = BK_VEC if vec else BK
    return (2 * p1 * ys + max(2 * (p2 + p3) * ts, RING * ma * A_ROW * 2)
            + RING * w_rows * (wide(width(c, cluster)) + 8) * 2 + 4 * ma)


def cluster_fits(c: int, feat: int, cluster: int) -> bool:
    """Each block of a cluster takes an equal share of every product's
    padded channels, in 16-byte units."""
    return all(n % (8 * cluster) == 0 for n in (2 * _round8(c), _round8(c), _round8(feat)))


class C2fPlan(NamedTuple):
    tile: int  # output pixels a side of a block's tile
    cluster: int  # blocks that share one tile
    vec: bool  # 16-byte copies (Cin, c and F multiples of 8) or scalar loads


def _vec(cin: int, c: int, feat: int, bf16: bool) -> bool:  # the 16-byte copies run
    return bf16 and cin % 8 == 0 and c % 8 == 0 and feat % 8 == 0


@functools.lru_cache(maxsize=None)
def layouts(bsz: int, h: int, wd: int, cin: int, c: int, feat: int, bf16: bool,
            n_sm: int = 132) -> tuple[C2fPlan, ...]:
    """The layouts of a shape (`c2f_plan`'s arguments) whose block's shared
    memory fits: each tile with each cluster whose blocks take equal shares
    of the channels (bfloat16; float32 takes one block a tile), with the
    16-byte copies where they run and with scalar loads.  All give the same
    bits: each output is summed in one order."""
    clusters = [s for s in (CLUSTERS if bf16 else (1,)) if cluster_fits(c, feat, s)]
    return tuple(C2fPlan(t, s, v) for v in ((True, False) if _vec(cin, c, feat, bf16) else (False,))
                 for t in TILES for s in clusters if smem_bytes(c, t, s, bf16, v) <= _SMEM_LIMIT)


@functools.lru_cache(maxsize=None)
def c2f_plan(bsz: int, h: int, wd: int, cin: int, c: int, feat: int, bf16: bool, n_sm: int = 132) -> C2fPlan:
    """The layout of `layouts` the kernel launches for a shape: the 16-byte
    copies where they run (raising if none fits), and in bfloat16 the first
    of: 8 x 8 with the least cluster (1, 2, 4) whose blocks fill the SMs and
    are all resident at once (shared memory); 8 x 8 with a cluster of 4 if
    that fills half the SMs; 4 x 4 as the first; else the most blocks that
    are all resident.  So a tile grows its cluster before it shrinks (a 4 x
    4 tile recomputes 2.25 times the halo), and no launch runs in two waves.
    On an H100 it picked the fastest tile and cluster at 16 of the 18 yolo-n
    sites at batch 1, 2 and 8 (`chip_smoke.py` phase 7 times every one;
    PERF.md section 6).  float32 (one block per tile, no cluster): 8 x 8
    where that gives three blocks for every four SMs, else 4 x 4; 2 x 2 only
    where shared memory allows nothing larger."""
    vec = _vec(cin, c, feat, bf16)
    fits = [p for p in layouts(bsz, h, wd, cin, c, feat, bf16, n_sm) if p.vec == vec]
    if not fits:
        raise ValueError(f"c2f_fused: no tile at c = {c} fits a block's shared memory")

    def tiles(t):
        return bsz * -(-h // t) * -(-wd // t)

    if bf16:
        def full(p, least):  # at least `least` blocks, all resident at once
            smem = smem_bytes(c, p.tile, p.cluster, True, vec)
            return least <= tiles(p.tile) * p.cluster <= n_sm * (conv_fused.SMEM_SM // (smem + 1024))

        order = [p for p in fits if p.tile >= 4] or fits
        largest = [p for p in order if p.tile == order[0].tile]
        return (next((p for p in largest if full(p, n_sm)), None)
                or next((p for p in largest if p.cluster == 4 and full(p, n_sm // 2)), None)
                or next((p for p in order if p not in largest and full(p, n_sm)), None)
                or max((p for p in order if full(p, 0)), key=lambda p: tiles(p.tile) * p.cluster, default=order[0]))
    prefer = [p for p in fits if p.tile >= 4] or fits
    return next((p for p in prefer if 4 * tiles(p.tile) >= 3 * n_sm), prefer[-1])


def _conv(x, w_hwio, b, pad):
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1).float(), b.float(), padding=pad)


def c2f_fused_plain(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, shortcut: bool = True):
    """Plain version of K8 with the kernel's rounding points; shapes as
    `c2f_fused`."""
    dt = x.dtype
    c = w1.shape[1] // 2
    y = F.silu(_conv(x.permute(0, 3, 1, 2).float(), w1[None, None], b1, 0)).to(dt)
    a, b = y[:, :c], y[:, c:]
    t1 = F.silu(_conv(b.float(), wm1, bm1, 1)).to(dt)
    t2 = F.silu(_conv(t1.float(), wm2, bm2, 1))
    p = (b.float() + t2 if shortcut else t2).to(dt)
    out = F.silu(_conv(torch.cat([a, b, p], dim=1).float(), w2[None, None], b2, 0))
    return out.permute(0, 2, 3, 1).contiguous().to(dt)


def c2f_fused(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, shortcut: bool = True, plan: C2fPlan | None = None):
    """Fused v8 ``C2f(features, n=1)`` forward on folded weights.

    ``x (B, H, W, Cin)``; ``w1 (Cin, 2c)``; ``wm1``, ``wm2 (3, 3, c, c)`` HWIO;
    ``w2 (3c, F)``, all of ``x``'s type (bfloat16 or float32); ``b1 (2c,)``,
    ``bm1``, ``bm2 (c,)``, ``b2 (F,)`` float32.  ``shortcut=False`` is the neck
    variant (``[a | b | t2]`` instead of ``[a | b | b + t2]``).  Returns
    ``(B, H, W, F)`` in ``x``'s type.  Launches the CUDA kernel for CUDA
    tensors, in ``plan`` (one of `layouts`; ``None``: `c2f_plan`'s); the
    plain version runs only for CPU tensors."""
    dev, dt = x.device, x.dtype
    if dt not in _TYPES:
        raise TypeError(f"c2f_fused: dtype {dt}, expected bfloat16 or float32")
    bsz, h, wd, cin = x.shape
    c, feat = w1.shape[1] // 2, w2.shape[1]
    pallas.check_tensor(x, "x", dt, (bsz, h, wd, cin), dev)
    pallas.check_tensor(w1, "w1", dt, (cin, 2 * c), dev)
    pallas.check_tensor(wm1, "wm1", dt, (3, 3, c, c), dev)
    pallas.check_tensor(wm2, "wm2", dt, (3, 3, c, c), dev)
    pallas.check_tensor(w2, "w2", dt, (3 * c, feat), dev)
    for name, t, n in (("b1", b1, 2 * c), ("bm1", bm1, c), ("bm2", bm2, c), ("b2", b2, feat)):
        pallas.check_tensor(t, name, torch.float32, (n,), dev)
    bf16 = dt == torch.bfloat16
    plan = pallas.chosen("c2f_fused", plan, c2f_plan, layouts, bsz, h, wd, cin, c, feat, bf16, _lib.sm_count(dev))
    if dev.type == "cpu":
        return c2f_fused_plain(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, shortcut)
    if dev.type != "cuda":
        raise ValueError(f"c2f_fused: unsupported device {dev}")
    out = torch.empty((bsz, h, wd, feat), dtype=dt, device=dev)
    err = _lib.lib().slam_c2f_fused(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), wm1.data_ptr(), bm1.data_ptr(), wm2.data_ptr(),
        bm2.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), bsz, h, wd, cin, c, feat,
        plan.tile, plan.cluster, int(shortcut), int(bf16), int(plan.vec), _lib.stream_ptr(dev),
    )
    _lib.check(err, "c2f_fused")
    pallas.LAUNCHES["c2f_fused"] += 1
    return out
