"""Masked voxel-grid downsampling and stable compaction with static shapes.

Counterpart of the JAX package's ``ops/voxel.py``: the same segment-mean
semantics (one averaged point per occupied voxel, grid anchored at the
origin), written with stable ``torch.sort``, gathers and one ``cumsum`` —
no ``unique``, ``nonzero``, boolean-mask indexing or ``.item()``, each of
which would synchronise with the host and make shapes data dependent.

Every function takes leading batch axes (the fleet's robot axis): clouds are
``(..., N, 2)`` with masks ``(..., N)``; sorts and the prefix sum run along
the last (contiguous) dim.
"""

from __future__ import annotations

import torch

_OFF = 4096          # voxel-index offset: coordinates in [-OFF, OFF) voxels
_STRIDE = 2 * _OFF   # row stride of the flattened voxel key
# invalid-point key: sorts after every real key (real keys < _STRIDE^2 = 2^26)
# and leaves bit 27 free for the segment-end flag of the second sort
_SENTINEL = 2**26


def voxel_keys(xy: torch.Tensor, valid: torch.Tensor, voxel_size) -> torch.Tensor:
    """Flattened int32 voxel key per point; invalid points get the sentinel.
    ``voxel_size`` is a float, or a sequence of floats with one size per row
    of the first axis (host numbers: no tensor is made from them)."""
    if isinstance(voxel_size, (tuple, list)):
        scaled = torch.stack([xy[r] / float(v) for r, v in enumerate(voxel_size)])
    else:
        scaled = xy / float(voxel_size)
    ij = torch.floor(scaled).to(torch.int32)
    ij = torch.clamp(ij + _OFF, 0, _STRIDE - 1)
    key = ij[..., 0] * _STRIDE + ij[..., 1]
    return torch.where(valid, key, torch.full_like(key, _SENTINEL))


def _seg(c: torch.Tensor) -> torch.Tensor:
    """Differences of consecutive inclusive prefix sums along the last dim."""
    return c - torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)


def voxel_downsample(xy: torch.Tensor, valid: torch.Tensor, voxel_size):
    """Segment-mean voxel downsample: ``(..., N, 2), (..., N) -> (..., N, 2),
    (..., N)``; ``voxel_size`` as in `voxel_keys`.

    One representative per occupied voxel, packed at the front in key order;
    invalid slots are zeroed.  After a stable sort by key, each segment's sum
    is the difference of inclusive prefix sums at consecutive segment ends,
    and a second stable sort on the packed (not-an-end flag, key) brings the
    ends to the front.  Coordinates accumulate split: ``hi`` is the nearest
    multiple of 32 mm (exact in f32), ``lo`` the residual in [-16, 16), which
    carries all the rounding error.  ``cumsum`` adds in another order on the
    card than on the CPU, so results agree to rounding (~1e-4 mm), not bits.
    """
    key = voxel_keys(xy, valid, voxel_size)
    w = valid.to(torch.float32)
    k, perm = torch.sort(key, dim=-1, stable=True)
    xs = torch.gather(xy[..., 0] * w, -1, perm)
    ys = torch.gather(xy[..., 1] * w, -1, perm)
    ws = (k != _SENTINEL).to(torch.float32)

    def split(v):
        hi = torch.round(v * (1.0 / 32.0)) * 32.0
        return hi, v - hi

    xh, xl = split(xs)
    yh, yl = split(ys)
    # the five prefix sums run as one scan along the contiguous dim: a scan
    # down an outer dim takes CUDA's slow outer-dim kernel
    c = torch.cumsum(torch.stack([xh, xl, yh, yl, ws], dim=-2), dim=-1)
    last = torch.cat([k[..., :-1] != k[..., 1:], torch.ones_like(k[..., :1], dtype=torch.bool)], dim=-1)
    pkey = torch.where(last, torch.zeros_like(k), torch.full_like(k, _SENTINEL * 2)) + k
    pk, perm2 = torch.sort(pkey, dim=-1, stable=True)
    s = _seg(torch.gather(c, -1, perm2[..., None, :].expand(c.shape)))
    sx = s[..., 0, :] + s[..., 1, :]
    sy = s[..., 2, :] + s[..., 3, :]
    sw = s[..., 4, :]
    out_valid = (pk < _SENTINEL) & (sw > 0)
    out_xy = torch.stack([sx, sy], dim=-1) / torch.clamp(sw, min=1.0)[..., None]
    out_xy = torch.where(out_valid[..., None], out_xy, torch.zeros_like(out_xy))
    return out_xy, out_valid


def voxel_downsample_batched(xys: torch.Tensor, valids: torch.Tensor, voxel_sizes):
    """Segment-mean downsample of same-length clouds at a voxel size per row
    of the leading axis in one call: ``(R, ..., N, 2), (R, ..., N)`` and ``R``
    sizes -> ``((R, ..., N, 2), (R, ..., N))``.  The realtime step runs its
    duplicate filter and its occupancy dedup through it as two rows."""
    if len(voxel_sizes) != xys.shape[0]:
        raise ValueError(f"{len(voxel_sizes)} voxel sizes for {xys.shape[0]} rows")
    return voxel_downsample(xys, valids, tuple(voxel_sizes))


def compact(xy: torch.Tensor, valid: torch.Tensor, capacity: int):
    """Stable-pack valid points to the front and truncate/pad to ``capacity``
    (insertion order is kept; points beyond ``capacity`` drop newest-last)."""
    key = (~valid).to(torch.int32)
    ks, perm = torch.sort(key, dim=-1, stable=True)
    xy_sorted = torch.gather(xy, -2, perm[..., None].expand(xy.shape))
    valid_sorted = ks == 0
    n = xy.shape[-2]
    if capacity <= n:
        return xy_sorted[..., :capacity, :], valid_sorted[..., :capacity]
    pad = capacity - n
    return (
        torch.cat([xy_sorted, xy.new_zeros((*xy.shape[:-2], pad, 2))], dim=-2),
        torch.cat([valid_sorted, valid.new_zeros((*valid.shape[:-1], pad))], dim=-1),
    )
