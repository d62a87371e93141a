"""K8: the whole v8 ``C2f(n=1)`` block in one kernel.

Counterpart of the JAX package's ``c2f_fused`` (``ops/pallas/c2f_fused.py``).
The CUDA kernel is ``csrc/c2f.cu``; its source says what bounds it and how it
is laid out.  The JAX kernel's weight arrangement (`arrange_c2f_weights`,
the permuted and banded matrices) is a layout workaround of its target and is
not carried over: the kernel takes the folded weights as they are.

Rounding points, as in the JAX kernel: ``a`` and ``b`` (the halves of
``silu(cv1(x))``) and ``t1`` are rounded to the working type; ``t2`` is not:
``p = float32(b) + t2`` is summed in float32 and then rounded.  The zero
padding of the two 3x3s is of the intermediates ``b`` and ``t1``, not of
``x``.  The four biases are float32, as the JAX serving path keeps them (the
single-conv kernels K5-K7 round theirs to the working type instead).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.pallas import _lib

_TYPES = (torch.bfloat16, torch.float32)
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may ask for on sm_90


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


def _pick_tile(lib, bsz: int, h: int, wd: int, c: int, bf16: bool, n_sm: int) -> int:
    """The block's output tile: 8 x 8 pixels when that fits shared memory and
    gives at least three blocks for every four SMs, else 4 x 4 (four times the
    blocks, 2.25 times the halo work; measured faster below that many blocks
    on an H100); 2 x 2 only where shared memory allows nothing larger."""
    fits = [t for t in (8, 4, 2) if lib.slam_c2f_smem_bytes(c, t, t, int(bf16)) <= _SMEM_LIMIT]
    if not fits:
        raise ValueError(f"c2f_fused: c = {c} does not fit a block's shared memory at any tile")
    prefer = [t for t in fits if t >= 4] or fits
    for t in prefer:
        if 4 * bsz * -(-h // t) * -(-wd // t) >= 3 * n_sm:
            return t
    return prefer[-1]


def c2f_fused(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, shortcut: bool = True, tile: int | None = None):
    """Fused v8 ``C2f(features, n=1)`` forward on folded weights.

    ``x (B, H, W, Cin)``; ``w1 (Cin, 2c)``; ``wm1``, ``wm2 (3, 3, c, c)`` HWIO;
    ``w2 (3c, F)``, all of ``x``'s type (bfloat16 or float32); ``b1 (2c,)``,
    ``bm1``, ``bm2 (c,)``, ``b2 (F,)`` float32.  ``shortcut=False`` is the neck
    variant (``[a | b | t2]`` instead of ``[a | b | b + t2]``).  Returns
    ``(B, H, W, F)`` in ``x``'s type.  ``tile`` overrides the block's output
    tile (pixels a side).  Launches the CUDA kernel for CUDA tensors; the
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
    if dev.type == "cpu":
        return c2f_fused_plain(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, shortcut)
    if dev.type != "cuda":
        raise ValueError(f"c2f_fused: unsupported device {dev}")
    lib = _lib.lib()
    bf16 = dt == torch.bfloat16
    if tile is None:
        tile = _pick_tile(lib, bsz, h, wd, c, bf16, torch.cuda.get_device_properties(dev).multi_processor_count)
    elif lib.slam_c2f_smem_bytes(c, tile, tile, int(bf16)) > _SMEM_LIMIT:
        raise ValueError(f"c2f_fused: a {tile} x {tile} tile at c = {c} does not fit a block's shared memory")
    out = torch.empty((bsz, h, wd, feat), dtype=dt, device=dev)
    err = lib.slam_c2f_fused(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), wm1.data_ptr(), bm1.data_ptr(), wm2.data_ptr(),
        bm2.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), bsz, h, wd, cin, c, feat,
        tile, tile, int(shortcut), int(bf16), _lib.stream_ptr(dev),
    )
    _lib.check(err, "c2f_fused")
    pallas.LAUNCHES["c2f_fused"] += 1
    return out
