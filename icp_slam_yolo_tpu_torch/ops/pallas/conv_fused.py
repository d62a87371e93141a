"""K5-K7: convolution + bias + SiLU in one kernel, NHWC, bf16 or f32.

Counterparts of the JAX package's ``conv1x1_silu``, ``conv3x3_silu`` and
``conv3x3s2_silu`` (``ops/pallas/conv_fused.py``).  The CUDA kernel is
``csrc/conv.cu``; its source says what bounds it and how it is laid out.
`conv_plan` picks its variant from the shape: the gather (16-byte copies or
scalar loads), the block's tile and how many blocks of a cluster split the
K axis, or the warpgroup loop (TMA copies, `wgmma` products).
The JAX kernels' pixel-group packing and banded weights are layout
workarounds of their target and are not carried over, and neither are their
shape conditions: every shape is taken, except an odd height or width at
stride 2, which raises as it does there.

Rounding, as in the JAX kernels: inputs, weights and the bias are in the
working type (the bias is rounded to it before the call and widened again in
the kernel), the sum and the SiLU are float32, the result is rounded once.
"""

from __future__ import annotations

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


def conv_plan(bsz: int, ho: int, wo: int, cin: int, cout: int, k: int, bf16: bool, n_sm: int = 132,
              vec: bool | None = None, split: int | None = None, wgmma: bool | None = None) -> ConvPlan:
    """The kernel's variant for a shape (output ``ho x wo``).  float32 takes
    the FMA tile (BM = 4096 / BN, no split).  bfloat16 takes the 16-byte
    gather where Cin and Cout are multiples of 8, and aims at about 1.5
    blocks per SM, the count at which an H100 ran every yolo-n site fastest
    or within a few per cent of it (`PERF.md` section 6):
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
    batch 8).  ``vec``, ``split`` and ``wgmma`` force those (a forced choice
    must be valid).  Every variant gives the same bits: the K axis is summed
    in `GROUPS` fixed groups whatever the split, and both warpgroup variants
    gave ``mma.sync``'s bits at every site `chip_smoke.py` compares (it
    requires so), which `detect_pair` needs: batch 1 and 2 take different
    variants."""
    bn = width(cout)
    if not bf16:
        if vec or wgmma or (split or 1) != 1:
            raise ValueError("conv: the float32 kernel has neither the 16-byte gather, a split nor wgmma")
        return ConvPlan(False, 4096 // bn, bn, 1)
    can_vec = cin % 8 == 0 and cout % 8 == 0
    if vec and not can_vec:
        raise ValueError(f"conv: the 16-byte gather needs Cin and Cout multiples of 8, got {cin} and {cout}")
    vec = can_vec if vec is None else vec
    m, n_tiles, units = bsz * ho * wo, -(-cout // bn), -(-k * k * cin // GROUP_UNIT)
    rows, aim = BF16_ROWS[bn], 1.5 * n_sm

    def blocks(r):
        return -(-m // r) * n_tiles

    def fits(r, s):  # shared memory of a block, and of all blocks at once when split
        smem = smem_bytes(ConvPlan(vec, r, bn, s), True)
        return smem <= SMEM_LIMIT and (s == 1 or blocks(r) * s <= n_sm * (SMEM_SM // (smem + 1024)))

    if units <= 2:
        bm = next((r for r in rows if r <= 64 and blocks(r) >= 6 * n_sm), rows[-1])
        auto = 1
    elif 128 in rows and aim <= blocks(128) <= 3.5 * n_sm:
        bm, auto = 128, 1
    else:
        bm = next((r for r in rows if r <= 64 and blocks(r) >= aim), None)
        auto = 1
        if bm is None:  # a small map: split the K axis
            splits = [(r, s) for r in (64, 32) if r in rows for s in SPLITS[1:] if s <= units and fits(r, s)]
            bm, auto = next(((r, s) for r, s in splits if blocks(r) * s >= aim),
                            max(splits, key=lambda rs: (blocks(rs[0]) * rs[1], rs[0])) if splits else (rows[-1], 1))
    tma = vec and cin % 64 == 0 and cout % 64 == 0
    wide = 128 if cout % 128 == 0 else 64  # the TMA-fed loop's columns at 128 rows
    full = -(-m // 128) * (cout // wide) >= n_sm  # its 128-row tiles fill the card once or more
    if wgmma is None:
        small = 3 * -(-m // 64) * (cout // 64) >= n_sm  # 64 x 64 tiles for a third of the SMs or more
        wgmma = (split or 1) == 1 and (tma and (full or (k == 3 and small))
                                       or not tma and k == 3 and vec and cout % 64 == 0 and auto == 1 and bm >= 64)
    if wgmma:
        if not vec or cout % 64 or (split or 1) != 1:
            raise ValueError(f"conv: wgmma needs the 16-byte gather, Cout a multiple of 64 and no split ({cin}->{cout})")
        if tma:
            return ConvPlan(True, 128, wide, 1, True, True) if full else ConvPlan(True, 64, 64, 1, True, True)
        return ConvPlan(True, 128 if bm == 128 else 64, 64, 1, True)
    if split is None:
        split = auto
    elif split not in SPLITS:
        raise ValueError(f"conv: split {split}, expected one of {SPLITS}")
    plan = ConvPlan(vec, bm, bn, split)
    if smem_bytes(plan, True) > SMEM_LIMIT:
        raise ValueError(f"conv: {plan} does not fit a block's shared memory")
    return plan


def use_kernels(batch: int, h: int) -> bool:
    """The regime gate of the fused path (`_use_pallas` in the JAX package).
    It answers yes for every batch and height: on an H100 (700 W) the fused
    bf16 forward was the faster on the wall clock at batch 1, 2, 8 and 32
    (`chip_smoke.py` phase 9, fused against unfused in turns, ms per
    forward: 7.9-8.9 against 9.2-15.0 at batch 1, 7.3-7.7 against 9.3-9.6 at
    2, 6.4-7.6 against 8.6-9.3 at 8, 7.7 against 9.6-10.1 at 32), so no
    cut-off is set.  At batch 32 the fused path is bound by the device and
    its forward takes more device time than the unfused one (6.8 against
    5.4 ms), so a host fast enough to issue the unfused path's 423 launches in
    under 6.8 ms would make it lose there; the closest reading with these
    kernels was a tie (8.29 against 8.30 ms, the means of two turns).  The JAX
    package's cut-offs were measured on its own target and are not copied."""
    return True


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


def _conv(name: str, x, w, b, stride: int, act: bool, vec: bool | None = None, split: int | None = None,
          wgmma: bool | None = None):
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
    plan = conv_plan(bsz, h // stride, wd // stride, cin, cout, k, bf16, _lib.sm_count(dev), vec, split, wgmma)
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


def conv1x1_silu(x, w, b, act: bool = True, vec: bool | None = None, split: int | None = None,
                 wgmma: bool | None = None):
    """K5: ``silu(x @ w + b)`` over the channel axis (``act=False``: no
    SiLU).  ``x (B, H, W, Cin)``, ``w (Cin, Cout)``, ``b (Cout,)``, all of one
    type.  Launches the CUDA kernel for CUDA tensors; the plain version runs
    only for CPU tensors.  ``vec``, ``split`` and ``wgmma`` override
    `conv_plan`'s gather, split and products."""
    if w.dim() != 2:
        raise ValueError(f"conv1x1_silu: w has shape {tuple(w.shape)}, expected (Cin, Cout)")
    return _conv("conv1x1_silu", x, w[None, None], b, 1, act, vec, split, wgmma)


def conv3x3_silu(x, w, b, vec: bool | None = None, split: int | None = None,
                 wgmma: bool | None = None):
    """K6: ``silu(conv3x3(x, w) + b)``, stride 1, SAME zero padding;
    ``w (3, 3, Cin, Cout)`` HWIO."""
    if w.dim() != 4 or w.shape[0] != 3 or w.shape[1] != 3:
        raise ValueError(f"conv3x3_silu: w has shape {tuple(w.shape)}, expected (3, 3, Cin, Cout)")
    return _conv("conv3x3_silu", x, w, b, 1, True, vec, split, wgmma)


def conv3x3s2_silu(x, w, b, vec: bool | None = None, split: int | None = None,
                   wgmma: bool | None = None):
    """K7: the same at stride 2 with padding 1 on even H and W: the window of
    output ``(i, j)`` covers input rows ``2i-1..2i+1`` (one zero row above the
    image, none below); out ``(B, H/2, W/2, Cout)``."""
    if w.dim() != 4 or w.shape[0] != 3 or w.shape[1] != 3:
        raise ValueError(f"conv3x3s2_silu: w has shape {tuple(w.shape)}, expected (3, 3, Cin, Cout)")
    return _conv("conv3x3s2_silu", x, w, b, 2, True, vec, split, wgmma)
