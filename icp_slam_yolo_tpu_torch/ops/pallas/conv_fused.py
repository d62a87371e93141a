"""K5-K7: convolution + bias + SiLU in one kernel, NHWC, bf16 or f32.

Counterparts of the JAX package's ``conv1x1_silu``, ``conv3x3_silu`` and
``conv3x3s2_silu`` (``ops/pallas/conv_fused.py``).  The CUDA kernel is
``csrc/conv.cu``; its source says what bounds it and how it is laid out.
`conv_plan` picks its layout of `layouts` from the shape: the gather (16-byte
copies or scalar loads), the block's tile and how many blocks of a cluster
split the K axis, or a warpgroup kernel (`wgmma` products).
The JAX kernels' pixel-group packing and banded weights are layout
workarounds of their target and are not carried over, and neither are their
shape conditions: every shape is taken, except an odd height or width at
stride 2, which raises as it does there.

Rounding, as in the JAX kernels: inputs, weights and the bias are in the
working type (the bias is rounded to it before the call and widened again in
the kernel), the sum and the SiLU are float32, the result is rounded once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.pallas import _lib

_TYPES = (torch.bfloat16, torch.float32)
BK = 32  # K values per chunk: the float32 tile and the scalar gather (the 16-byte gather: 64)
STAGES = 4  # chunks in the bfloat16 kernel's shared-memory ring
TMA_STAGES = 5  # chunks in the ring of the TMA-fed warpgroup loop (conv.cu's `kTmaStages`)
SPLITS = (1, 2, 4, 8)  # blocks of a cluster that share one output tile
GROUPS, GROUP_UNIT = 8, 64  # the K axis is summed in 8 fixed groups of 64-value blocks, whatever the split
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may ask for on sm_90
SMEM_SM = 228 * 1024  # shared memory of an SM, 1 KB of it reserved per resident block
# bfloat16 tiles: rows (output pixels) a block takes, by its column width
BF16_ROWS = {16: (128, 64), 32: (128, 64, 32), 64: (128, 64, 32)}


class ConvPlan(NamedTuple):
    vec: bool  # 16-byte copies (Cin and Cout multiples of 8) or scalar loads
    bm: int  # output pixels of a block's tile
    bn: int  # output channels of a block's tile
    split: int  # blocks of a cluster that split the K axis of one tile
    wgmma: bool = False  # warpgroup products (64 rows a warpgroup) in place of mma.sync
    tma: bool = False  # of them the TMA-fed loop (Cin a multiple of 64), not the 64-row kernel that gathers itself


def width(cout: int) -> int:
    """A block's output channels: 16, 32 or 64, the least that holds Cout."""
    return 16 if cout <= 16 else 32 if cout <= 32 else 64


def smem_bytes(plan: ConvPlan, bf16: bool) -> int:
    """Shared memory a block of this plan takes (conv.cu's `launch_bf16`:
    the ring, the row tables and, when split, the float32 sums of the
    `GROUPS` groups for its share of the tile's rows; the float32 tile's is
    static)."""
    if not bf16:
        return 4 * (BK * plan.bn + plan.bm * (BK + 1)) + 12 * plan.bm
    if plan.tma:  # conv.cu's `TmaTile`: 1024 bytes to align the ring; A's rows and W's 64 x BN of a 64-value
        # chunk a stage; a full and an empty barrier a stage; the staged output tile
        return 1024 + TMA_STAGES * (plan.bm + plan.bn) * 128 + 16 * TMA_STAGES + plan.bm * (plan.bn + 8) * 2
    if plan.wgmma:  # 1024 bytes to align the ring; A's rows and W's 64 x 64 of a 64-value chunk
        return 1024 + STAGES * (plan.bm + 64) * 128 + 12 * plan.bm
    bk = 2 * BK if plan.vec else BK
    parts = GROUPS // plan.split * plan.bm * plan.bn * 4 if plan.split > 1 else 0
    return STAGES * (plan.bm * (bk + 8) + bk * (plan.bn + 8)) * 2 + 12 * plan.bm + parts


@functools.lru_cache(maxsize=None)
def layouts(bsz: int, ho: int, wo: int, cin: int, cout: int, k: int, bf16: bool,
            n_sm: int = 132) -> tuple[ConvPlan, ...]:
    """The layouts of a shape (`conv_plan`'s arguments) whose block's shared
    memory fits, so the channels alone decide.  float32: the FMA tile (BM =
    4096 / BN, no split).  bfloat16: each ``mma.sync`` tile of the width
    (`BF16_ROWS`), its K axis unsplit or split over a cluster (`SPLITS`),
    with the 16-byte gather (Cin and Cout multiples of 8) and with scalar
    loads; with Cout a multiple of 64 too, the 64-row warpgroup kernel on
    128 or 64 rows; with Cin as well, the TMA-fed loop on 128 x 128 (Cout a
    multiple of 128), 128 x 64 and 64 x 64 tiles.  All give the same bits:
    the K axis is summed in `GROUPS` fixed groups whatever the split, and
    the warpgroup products give ``mma.sync``'s (`chip_smoke.py` phase 7), as
    `detect_pair` needs: batch 1 and 2 take different layouts."""
    bn = width(cout)
    if not bf16:
        return (ConvPlan(False, 4096 // bn, bn, 1),)
    vec = cin % 8 == 0 and cout % 8 == 0
    plans = [ConvPlan(v, r, bn, s) for v in ((True, False) if vec else (False,))
             for r in BF16_ROWS[bn] for s in SPLITS]
    if vec and cout % 64 == 0:
        plans += [ConvPlan(True, r, 64, 1, True) for r in (128, 64)]
        if cin % 64 == 0:  # the TMA-fed loop
            plans += [ConvPlan(True, r, n, 1, True, True) for r, n in ((128, 128), (128, 64), (64, 64))
                      if cout % n == 0]
    return tuple(p for p in plans if smem_bytes(p, True) <= SMEM_LIMIT)


@functools.lru_cache(maxsize=None)
def conv_plan(bsz: int, ho: int, wo: int, cin: int, cout: int, k: int, bf16: bool, n_sm: int = 132) -> ConvPlan:
    """The layout of `layouts` the kernel launches for a shape (output ``ho x
    wo``).  bfloat16 takes the 16-byte gather where it runs, and aims at
    about 1.5 blocks per SM, the count at which an H100 ran every yolo-n
    site fastest or within a few per cent of it (`PERF.md` section 6):
      * a short K axis (at most two 64-value blocks: the 1x1s of 64 and 128
        channels) is never split: the narrowest rows, or 64 on large maps;
      * otherwise 128 rows where they give 1.5-3.5 blocks per SM, else 64
        rows, else 32, where those give 1.5 blocks per SM;
      * on maps too small for that, the K axis is split over a cluster of
        2, 4 or 8 blocks: the least split of 64 rows, then of 32, that
        reaches the aim (else the most blocks), as long as each block keeps a
        64-value block of the K axis and all blocks fit the SMs' shared
        memory at once (a split block keeps its sums there).
    Sites with Cin and Cout multiples of 64 take the TMA-fed warpgroup loop
    (``wgmma`` and ``tma``: a producer thread's TMA boxes, products kept in
    flight, no split) on 128-row tiles, 128 columns where Cout allows,
    wherever those tiles fill the card's SMs once or more: YOLO12-L's wide
    sites, bound by operations, and v8n's from batch 8 or 32.  Such a 3x3
    takes the loop on 64 x 64 tiles where those number a third of the SMs
    or more.  Readings on an H100 (`chip_smoke.py` phase 7, us; `PERF.md`
    section 6): YOLO12-L's 141 such sites at batch 32 took 28.5 ms a forward
    against 55.5 on the 64-row warpgroup kernel and 62.6 on ``mma.sync``; the
    loop was faster than the plan before it at every v8n and YOLO12-L 3x3 of
    50 or more 64 x 64 tiles at batch 2 and 8 (7.56 against 10.25 at 64->64
    on 40 x 40, 10.73 against 25.84 at 128->128 stride 2 from 40 x 40), and
    slower at 13-32 tiles, where the plan splits the K axis (17.20 against
    9.70 at 256->64 on 20 x 20, batch 2); a 1x1 of 128 rows a tile or fewer
    gained nothing at 64 rows (7.92 against 7.41 at 64->64 on 80 x 80, batch
    2).  The 3x3s with Cout a multiple of 64 and another Cin that are neither
    split nor given 32 rows take the 64-row warpgroup kernel, whose threads
    gather (24.84 against 38.57 on ``mma.sync`` at v8n's 32->64, stride 2,
    batch 8)."""
    fits = layouts(bsz, ho, wo, cin, cout, k, bf16, n_sm)
    if not bf16:
        return fits[0]
    vec = any(p.vec for p in fits)
    bn = width(cout)
    m, n_tiles, units = bsz * ho * wo, -(-cout // bn), -(-k * k * cin // GROUP_UNIT)
    rows, aim = BF16_ROWS[bn], 1.5 * n_sm

    def blocks(r):
        return -(-m // r) * n_tiles

    def resident(p):  # all blocks of a split at once, each keeping its sums in shared memory
        return blocks(p.bm) * p.split <= n_sm * (SMEM_SM // (smem_bytes(p, True) + 1024))

    split = 1
    if units <= 2:
        bm = next((r for r in rows if r <= 64 and blocks(r) >= 6 * n_sm), rows[-1])
    elif 128 in rows and aim <= blocks(128) <= 3.5 * n_sm:
        bm = 128
    else:
        bm = next((r for r in rows if r <= 64 and blocks(r) >= aim), None)
        if bm is None:  # a small map: split the K axis
            splits = [(p.bm, p.split) for p in fits if p.vec == vec and not p.wgmma and p.bm <= 64
                      and 1 < p.split <= units and resident(p)]
            bm, split = next(((r, s) for r, s in splits if blocks(r) * s >= aim),
                             max(splits, key=lambda rs: (blocks(rs[0]) * rs[1], rs[0])) if splits else (rows[-1], 1))
    loop = [p for p in fits if p.tma]  # the TMA-fed loop: 128 rows (its widest first), then 64 x 64
    if loop:
        full = -(-m // 128) * (cout // loop[0].bn) >= n_sm  # its 128-row tiles fill the card once or more
        if full or (k == 3 and 3 * -(-m // 64) * (cout // 64) >= n_sm):  # 64 x 64 tiles for a third of the SMs
            return loop[0] if full else loop[-1]
    elif k == 3 and vec and cout % 64 == 0 and split == 1 and bm >= 64:
        return ConvPlan(True, 128 if bm == 128 else 64, 64, 1, True)
    return ConvPlan(vec, bm, bn, split)


def conv_bias_act_plain(x, w, b, stride: int = 1, act: bool = True):
    """Plain version of K5-K7: ``x (B, H, W, Cin)``, ``w (k, k, Cin, Cout)``
    HWIO, ``b (Cout,)`` -> ``(B, Ho, Wo, Cout)`` in ``x.dtype``; padding
    ``k // 2``, float32 sum and SiLU, one rounding at the end."""
    k = w.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.permute(3, 2, 0, 1).float(), b.float(),
                 stride=stride, padding=k // 2)
    if act:
        y = F.silu(y)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def _conv(name: str, x, w, b, stride: int, act: bool, plan: ConvPlan | None):
    dev, dt = x.device, x.dtype
    if dt not in _TYPES:
        raise TypeError(f"{name}: dtype {dt}, expected bfloat16 or float32")
    bsz, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    pallas.check_tensor(x, "x", dt, (bsz, h, wd, cin), dev)
    pallas.check_tensor(w, "w", dt, (k, k, cin, cout), dev)
    pallas.check_tensor(b, "b", dt, (cout,), dev)
    if stride == 2 and (h % 2 or wd % 2):
        raise ValueError(f"{name}: stride 2 needs even H and W, got {h} x {wd}")
    bf16 = dt == torch.bfloat16
    plan = pallas.chosen(name, plan, conv_plan, layouts, bsz, h // stride, wd // stride, cin, cout, k, bf16,
                         _lib.sm_count(dev))
    if dev.type == "cpu":
        return conv_bias_act_plain(x, w, b, stride, act)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    out = torch.empty((bsz, h // stride, wd // stride, cout), dtype=dt, device=dev)
    err = _lib.lib().slam_conv_bias_act(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, h, wd, cin, cout,
        k, stride, int(act), int(bf16), int(plan.vec), plan.bm, plan.bn, plan.split, plan.wgmma + plan.tma,
        _lib.stream_ptr(dev),
    )
    _lib.check(err, name)
    pallas.LAUNCHES[name] += 1
    pallas.LAUNCHES["conv_tma"] += plan.tma
    return out


def conv1x1_silu(x, w, b, act: bool = True, plan: ConvPlan | None = None):
    """K5: ``silu(x @ w + b)`` over the channel axis (``act=False``: no
    SiLU).  ``x (B, H, W, Cin)``, ``w (Cin, Cout)``, ``b (Cout,)``, all of one
    type.  Launches the CUDA kernel for CUDA tensors, in ``plan`` (one of
    `layouts`; ``None``: `conv_plan`'s); the plain version runs only for CPU
    tensors."""
    if w.dim() != 2:
        raise ValueError(f"conv1x1_silu: w has shape {tuple(w.shape)}, expected (Cin, Cout)")
    return _conv("conv1x1_silu", x, w[None, None], b, 1, act, plan)


def conv3x3_silu(x, w, b, plan: ConvPlan | None = None):
    """K6: ``silu(conv3x3(x, w) + b)``, stride 1, SAME zero padding;
    ``w (3, 3, Cin, Cout)`` HWIO."""
    if w.dim() != 4 or w.shape[0] != 3 or w.shape[1] != 3:
        raise ValueError(f"conv3x3_silu: w has shape {tuple(w.shape)}, expected (3, 3, Cin, Cout)")
    return _conv("conv3x3_silu", x, w, b, 1, True, plan)


def conv3x3s2_silu(x, w, b, plan: ConvPlan | None = None):
    """K7: the same at stride 2 with padding 1 on even H and W: the window of
    output ``(i, j)`` covers input rows ``2i-1..2i+1`` (one zero row above the
    image, none below); out ``(B, H/2, W/2, Cout)``."""
    if w.dim() != 4 or w.shape[0] != 3 or w.shape[1] != 3:
        raise ValueError(f"conv3x3s2_silu: w has shape {tuple(w.shape)}, expected (3, 3, Cin, Cout)")
    return _conv("conv3x3s2_silu", x, w, b, 2, True, plan)
