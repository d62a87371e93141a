"""Image codecs and helpers on numpy, ``zlib`` and ``struct`` alone: PNG in
and out, JPEG in (to PIL's pixels) and out, PIL's 8-bit resampling, and the
image helpers of the JAX package's ``utils/images.py``.

The machine the port serves from may have no imaging package, so the server's
``image/png`` and ``image/jpeg`` responses, the saved occupancy maps, the
replayed camera frames and the labeler's images all go through this module.

* `encode_png` / `decode_png`: the encoder writes 8-bit gray, RGB and RGBA
  without interlace; the decoder reads every colour type at every depth up
  to 8 bits (palettes with their ``tRNS`` alphas, 1-, 2- and 4-bit gray),
  Adam7 interlacing and all five row filters.
* `encode_jpeg`: baseline sequential JPEG (ITU T.81), 4:2:0 or 4:4:4, the
  Annex K quantisation tables scaled by ``quality`` as libjpeg scales them
  and the Annex K Huffman tables, with libjpeg's integer arithmetic
  (fixed-point colour, biased 2 x 2 downsampling, the ISLOW DCT, rounded
  division): PIL decodes the pixels of its own save at that quality.
* `decode_jpeg`: baseline, extended and progressive Huffman JPEG, gray,
  YCbCr, RGB and Adobe CMYK, decoded bit for bit as libjpeg-turbo decodes
  it for PIL (CMYK then as PIL's ``convert("RGB")``); `image_size` reads a
  PNG's or JPEG's size from its header.
* `resize_bilinear` / `resize_bicubic`: ``Image.resize`` of uint8 images.
* `read_image` / `write_image`: a file by its extension (PNG, JPEG,
  ``.npy``).
"""

from __future__ import annotations

import collections
import math
import os
import shutil
import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------- PNG

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> colour type (gray, RGB, RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
_PNG_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}  # the depths read


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray) -> bytes:
    """``(H, W)`` gray, ``(H, W, 3)`` RGB or ``(H, W, 4)`` RGBA uint8 -> PNG
    bytes (every row filtered with type 0, deflate at level 6)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 pixels, not {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[2] not in _PNG_COLOR_TYPES:
        raise ValueError(f"encode_png takes (H, W), (H, W, 3) or (H, W, 4), not {np.shape(img)}")
    h, w, c = arr.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)  # a filter byte (0, none) ahead of each row
    rows[:, 1:] = arr.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPES[c], 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth_row(raw: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the Paeth filter of one row (each byte depends on the one ``bpp``
    to its left, so the row is walked in order)."""
    out = raw.astype(np.int64).tolist()
    b = up.astype(np.int64).tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        c = b[i - bpp] if i >= bpp else 0
        p = a + b[i] - c
        pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.array(out, np.uint8)


def _average_row(raw: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    out = raw.astype(np.int64).tolist()
    b = up.astype(np.int64).tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + b[i]) >> 1)) & 0xFF
    return np.array(out, np.uint8)


def _unfilter(raw: np.ndarray, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of ``raw (H, 1 + stride)`` (a filter byte ahead
    of each row) -> ``(H, stride)`` bytes; ``bpp`` is the filters' byte
    distance to the left neighbour (at least 1)."""
    h = raw.shape[0]
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, row = raw[y, 0], raw[y, 1:]
        if kind == 0:
            cur = row
        elif kind == 1:  # Sub: a running sum of each byte lane along the row
            lanes = np.zeros(-(-stride // bpp) * bpp, np.int64)
            lanes[:stride] = row
            cur = (np.cumsum(lanes.reshape(-1, bpp), axis=0) & 0xFF).astype(np.uint8).reshape(-1)[:stride]
        elif kind == 2:  # Up
            cur = row + prev
        elif kind == 3:
            cur = _average_row(row, prev, bpp)
        elif kind == 4:
            cur = _paeth_row(row, prev, bpp)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def _samples(rows: np.ndarray, n: int, depth: int) -> np.ndarray:
    """The first ``n`` samples of each row of ``depth``-bit samples packed
    most significant bit first -> ``(H, n)`` uint8 values."""
    if depth == 8:
        return rows[:, :n]
    bits = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[:, :n]


# Adam7's passes: (x0, y0, dx, dy) of the pixels each one carries
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> the pixels PIL's ``convert("RGB")`` and ``convert("L")``
    start from, uint8: ``(H, W)`` gray (1-, 2- and 4-bit gray scaled to
    0-255 as PIL scales it), ``(H, W, 2)`` gray + alpha, ``(H, W, 3)`` RGB
    or ``(H, W, 4)`` RGBA; a palette image (1, 2, 4 or 8 bits) comes back
    as its colours, RGB, or RGBA with the ``tRNS`` alphas (an index past
    the palette is black, as PIL reads it).  Takes any of the five row
    filters and Adam7 interlacing; refuses 16-bit samples by name (PIL's
    ``convert`` clamps them to 255)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header, palette, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[: len(body) // 3 * 3].reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth == 16:
        raise ValueError(f"16-bit PNG (colour type {color}) is not read: PIL's convert clamps its samples to 255")
    if color not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[color]:
        raise ValueError(f"PNG with bit depth {depth} and colour type {color} is not a valid PNG")
    if color == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    if interlace > 1:
        raise ValueError(f"PNG interlace method {interlace} is not a valid PNG")
    chans = _PNG_CHANNELS[color]
    bpp = max(1, chans * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(-(-(w - x0) // dx), -(-(h - y0) // dy)) for x0, y0, dx, dy in passes]
    need = sum(ph * (1 + -(-pw * chans * depth // 8)) for pw, ph in sizes if pw and ph)
    if raw.size != need:
        raise ValueError(f"PNG data holds {raw.size} bytes, the header asks for {need}")
    out = np.zeros((h, w * chans), np.uint8)
    at = 0
    for (x0, y0, dx, dy), (pw, ph) in zip(passes, sizes):
        if not pw or not ph:  # a pass with no pixels has no rows, not even filter bytes
            continue
        stride = -(-pw * chans * depth // 8)
        rows = _unfilter(raw[at:at + ph * (stride + 1)].reshape(ph, stride + 1), stride, bpp)
        at += ph * (stride + 1)
        out.reshape(h, w, chans)[y0::dy, x0::dx] = _samples(rows, pw * chans, depth).reshape(ph, pw, chans)
    if color == 3:
        colours = np.zeros((256, 4), np.uint8)
        colours[:, 3] = 255
        colours[:len(palette), :3] = palette[:256]
        if trns is not None:
            colours[:len(trns[:256]), 3] = trns[:256]
        return colours[out][..., :3 if trns is None else 4]
    if depth < 8:  # gray at 1, 2 or 4 bits
        out = out * np.uint8(255 // ((1 << depth) - 1))
    return out.reshape(h, w) if chans == 1 else out.reshape(h, w, chans)


# --------------------------------------------------------------------- JPEG

# ITU T.81 Annex K.1: luminance and chrominance quantisation, natural order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]).reshape(8, 8)
_Q_CHROMA = np.full((8, 8), 99)
_Q_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]

# natural index of each zig-zag position
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def _ac_values(head: list[int], tail: list[int]) -> list[int]:
    """An Annex K AC table's symbols: a listed head, then ``(run << 4) | size``
    for the runs in ``tail`` with each run's remaining sizes in order."""
    out = list(head)
    for first in tail:
        run, size = first >> 4, first & 15
        out += [(run << 4) | s for s in range(size, 11)]
    return out


# ITU T.81 Annex K.3: (code counts by length 1..16, symbols)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], _ac_values(
    [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
     0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
     0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25],
    [0x26, 0x34, 0x43, 0x53, 0x63, 0x73, 0x83, 0x92, 0xA2, 0xB2, 0xC2, 0xD2, 0xE1, 0xF1]))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _ac_values(
    [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
     0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
     0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26],
    [0x27, 0x35, 0x43, 0x53, 0x63, 0x73, 0x82, 0x92, 0xA2, 0xB2, 0xC2, 0xD2, 0xE2, 0xF2]))


def _huffman_codes(table) -> tuple[np.ndarray, np.ndarray]:
    """Canonical codes of a ``(counts, symbols)`` table: ``(code, length)``
    arrays indexed by symbol (0-255)."""
    counts, symbols = table
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


# libjpeg's ISLOW integer DCT (jfdctint.c, jidctint.c): CONST_BITS = 13,
# PASS1_BITS = 2, FIX(x) = round(x * 2^13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _fdct_butterfly(x):
    """jfdctint.c's ``jpeg_fdct_islow`` pass over the last axis of ``x``
    before its descaling: the eight outputs as integer combinations of the
    inputs (outputs 0 and 4 scaled by 2^13 like the rest, so that one shift
    descales every output: 11 bits after the rows' pass, 15 after the
    columns')."""
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[..., i] for i in range(8))
    tmp0, tmp7, tmp1, tmp6 = x0 + x7, x0 - x7, x1 + x6, x1 - x6
    tmp2, tmp5, tmp3, tmp4 = x2 + x5, x2 - x5, x3 + x4, x3 - x4
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z1 = (tmp12 + tmp13) * _F0541
    z1, z2, z3, z4, even = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7, (z1 + tmp13 * _F0765, z1 - tmp12 * _F1847)
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    return np.stack([(tmp10 + tmp11) << 13, tmp7 + z1 + z4, even[0], tmp6 + z2 + z3, (tmp10 - tmp11) << 13,
                     tmp5 + z2 + z4, even[1], tmp4 + z1 + z3], axis=-1)


def _idct_butterfly(x):
    """jidctint.c's ``jpeg_idct_islow`` pass over the last axis of ``x``
    before its descaling (11 bits after the columns' pass, 18 after the
    rows')."""
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[..., i] for i in range(8))
    z1 = (x2 + x6) * _F0541
    tmp2, tmp3 = z1 - x6 * _F1847, z1 + x2 * _F0765
    tmp0, tmp1 = (x0 + x4) << 13, (x0 - x4) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3],
                    axis=-1)


# each pass as an integer matrix: row i holds input i's weight in every output
_FDCT = _fdct_butterfly(np.eye(8, dtype=np.int64)).astype(np.float64)
_IDCT = _idct_butterfly(np.eye(8, dtype=np.int64)).astype(np.float64)


def _islow_pass(x: np.ndarray, matrix: np.ndarray, shift: int) -> np.ndarray:
    """One pass over the last axis: the integer combinations (a float64
    product, exact: every value stays far below 2^53), then libjpeg's
    ``DESCALE`` (add half, shift right arithmetically)."""
    return (np.rint(x.astype(np.float64) @ matrix).astype(np.int64) + (1 << (shift - 1))) >> shift


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """``(H, W)`` with both a multiple of 8 -> ``(H/8, W/8, 8, 8)``."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _coefficients(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Level-shifted DCT and quantisation of every block of a uint8 plane,
    as libjpeg does them (the rows' pass, then the columns', then each
    coefficient divided by 8 q, rounded half away from zero): ``(by, bx,
    64)`` int64 in zig-zag order."""
    x = _blocks(plane.astype(np.int64) - 128)
    f = np.swapaxes(_islow_pass(np.swapaxes(_islow_pass(x, _FDCT, 11), -1, -2), _FDCT, 15), -1, -2)  # (.., v, u)
    div = (8 * q).reshape(8, 8)
    # float64 division is exact here (correctly rounded, and a quotient that is
    # not a whole number stays far from one), and much faster than int64's
    c = np.copysign(np.floor((np.abs(f) + (div >> 1)) / div), f).astype(np.int64)
    return c.reshape(*f.shape[:2], 64)[..., _ZIGZAG]


def _magnitude(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """JPEG's size category of each value (its magnitude's bit length) and
    its amplitude bits."""
    size = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    bits = np.where(v >= 0, v, v + (1 << size) - 1)
    return size, bits


def _entropy_symbols(coef: np.ndarray, dc_table, ac_table):
    """The Huffman-coded symbols of blocks ``(n, 64)`` (in the order they
    are written), block by block: ``(counts, bits, lens)``, ``counts[b]``
    the symbols of block b (its DC difference; each nonzero coefficient's
    zero-run escapes (ZRL) and the coefficient; the end of block), which
    ``bits`` and ``lens`` hold in writing order."""
    dc_code, dc_len = _huffman_codes(dc_table)
    ac_code, ac_len = _huffman_codes(ac_table)
    n = len(coef)
    blk, pos = np.nonzero(coef[:, 1:])
    pos = pos + 1
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    run = pos - np.where(first, 0, np.concatenate([[0], pos[:-1]])) - 1
    zrl = run >> 4
    emits = zrl + 1  # symbols a nonzero coefficient writes
    per_block = np.bincount(blk, weights=emits, minlength=n).astype(np.int64)
    last = np.zeros(n, np.int64)
    is_last = np.append(first[1:], True) if len(blk) else np.zeros(0, bool)
    last[blk[is_last]] = pos[is_last]
    eob = last < 63
    counts = 1 + per_block + eob
    start = np.cumsum(counts) - counts
    before = np.cumsum(emits) - emits  # every block's coefficients' symbols ahead of each
    at = start[blk] + 1 + before - (np.cumsum(per_block) - per_block)[blk]
    bits, lens = np.empty(int(counts.sum()), np.int64), np.empty(int(counts.sum()), np.int64)

    size, amp = _magnitude(np.diff(coef[:, 0], prepend=0))
    bits[start], lens[start] = (dc_code[size] << size) | amp, dc_len[size] + size
    for j in range(3):  # runs of 16 zeros ahead of the coefficient
        m = zrl > j
        bits[at[m] + j], lens[at[m] + j] = ac_code[0xF0], ac_len[0xF0]
    size, amp = _magnitude(coef[blk, pos])
    sym = ((run & 15) << 4) | size
    bits[at + zrl], lens[at + zrl] = (ac_code[sym] << size) | amp, ac_len[sym] + size
    ends = (start + counts - 1)[eob]
    bits[ends], lens[ends] = ac_code[0x00], ac_len[0x00]
    return counts, bits, lens


def _pack_bits(bits: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate codes (MSB first), pad the last byte with ones and stuff a
    zero byte after every 0xFF."""
    ends = np.cumsum(lens)
    # each bit of the stream: its code, shifted right by the bits that follow it in the code
    shift = np.repeat(ends - 1, lens) - np.arange(int(ends[-1]) if len(ends) else 0)
    stream = ((np.repeat(bits, lens) >> shift) & 1).astype(np.uint8)
    stream = np.concatenate([stream, np.ones((-len(stream)) % 8, np.uint8)])
    out = np.packbits(stream)
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def _rgb_to_ycbcr(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """jccolor.c's ``rgb_ycc_convert``: 16-bit fixed point, Cb and Cr
    rounded by 0.5 - 2^-16."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))  # every sum stays below 2^25
    half, center = 1 << 15, 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + center + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + center + half - 1) >> 16
    return y, cb, cr


def _downsample_2x2(plane: np.ndarray) -> np.ndarray:
    """jcsample.c's ``h2v2_downsample``: each 2 x 2 sum plus a bias of 1
    and 2 in turn along the row, over 4."""
    s = plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] + plane[1::2, 1::2]
    return (s + np.where(np.arange(plane.shape[1] // 2) % 2 == 0, 1, 2)) >> 2


def _pad_to(img: np.ndarray, h: int, w: int) -> np.ndarray:
    pad = [(0, h - img.shape[0]), (0, w - img.shape[1])] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="edge")


def encode_jpeg(img: np.ndarray, quality: int = 85, subsampling: str = "4:2:0") -> bytes:
    """``(H, W)`` gray or ``(H, W, 3)`` RGB uint8 -> baseline JPEG bytes
    (JFIF).  ``subsampling`` is ``"4:2:0"`` (chroma halved both ways, the
    usual camera setting) or ``"4:4:4"``; gray has one component."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes uint8 pixels, not {arr.dtype}")
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3), not {arr.shape}")
    if subsampling not in ("4:2:0", "4:4:4"):
        raise ValueError(f"subsampling {subsampling!r}: '4:2:0' or '4:4:4'")
    h, w = arr.shape[:2]
    ql, qc = _quant_table(_Q_LUMA, quality), _quant_table(_Q_CHROMA, quality)
    gray = arr.ndim == 2
    m = 16 if (subsampling == "4:2:0" and not gray) else 8  # the MCU's side
    mh, mw = -(-h // m), -(-w // m)
    if gray:
        y = _coefficients(_pad_to(arr, mh * m, mw * m), ql).reshape(-1, 64)
        groups = [(y, _DC_LUMA, _AC_LUMA, np.arange(len(y)))]
        comps = [(1, 0x11, 0)]
    else:
        yp, cb, cr = _rgb_to_ycbcr(arr)
        yp = _pad_to(yp, mh * m, mw * m)
        if m == 16:
            # as libjpeg: the edges replicated to a whole 2 x 2 group (and
            # across the chroma's last block), downsampled, then the last
            # downsampled row replicated down to the MCU's edge
            cw = 16 * -(-w // 16)
            cb, cr = (_pad_to(_downsample_2x2(_pad_to(c, h + h % 2, cw)), mh * 8, mw * 8) for c in (cb, cr))
        else:
            cb, cr = _pad_to(cb, mh * m, mw * m), _pad_to(cr, mh * m, mw * m)
        yc = _coefficients(yp, ql)  # (mh * m / 8, mw * m / 8, 64)
        per = (m // 8) ** 2 + 2  # blocks an MCU: Y blocks, then Cb, Cr
        by, bx = np.meshgrid(np.arange(yc.shape[0]), np.arange(yc.shape[1]), indexing="ij")
        k = m // 8
        y_order = ((by // k) * mw + bx // k) * per + (by % k) * k + bx % k
        mcu = np.arange(mh * mw)
        groups = [(yc.reshape(-1, 64), _DC_LUMA, _AC_LUMA, y_order.reshape(-1)),
                  (_coefficients(cb, qc).reshape(-1, 64), _DC_CHROMA, _AC_CHROMA, mcu * per + per - 2),
                  (_coefficients(cr, qc).reshape(-1, 64), _DC_CHROMA, _AC_CHROMA, mcu * per + per - 1)]
        comps = [(1, 0x22 if m == 16 else 0x11, 0), (2, 0x11, 1), (3, 0x11, 1)]

    # each component's symbols block by block (DC differences run in the order
    # blocks are written), then every block's run placed where its block is written
    runs = []
    for coef, dct, act, emit in groups:
        rank = np.argsort(emit)
        runs.append((emit[rank],) + _entropy_symbols(coef[rank], dct, act))
    written = np.zeros(sum(len(r[0]) for r in runs), np.int64)
    for emit, counts, _, _ in runs:
        written[emit] = counts
    offset = np.cumsum(written) - written
    bits, lens = np.empty(int(written.sum()), np.int64), np.empty(int(written.sum()), np.int64)
    for emit, counts, b, ln in runs:
        dest = np.repeat(offset[emit] - (np.cumsum(counts) - counts), counts) + np.arange(len(b))
        bits[dest], lens[dest] = b, ln
    scan = _pack_bits(bits, lens)

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    out.append(_segment(0xDB, b"\x00" + bytes(ql.reshape(64)[_ZIGZAG].tolist())))
    if not gray:
        out.append(_segment(0xDB, b"\x01" + bytes(qc.reshape(64)[_ZIGZAG].tolist())))
    sof = struct.pack(">BHHB", 8, h, w, len(comps)) + b"".join(struct.pack(">BBB", *c) for c in comps)
    out.append(_segment(0xC0, sof))
    tables = [(0x00, _DC_LUMA), (0x10, _AC_LUMA)] + ([] if gray else [(0x01, _DC_CHROMA), (0x11, _AC_CHROMA)])
    for cls_id, (counts, symbols) in tables:
        out.append(_segment(0xC4, bytes([cls_id] + counts + symbols)))
    sos = bytes([len(comps)] + [v for cid, _, t in comps for v in (cid, (t << 4) | t)] + [0, 63, 0])
    out += [_segment(0xDA, sos), scan, b"\xff\xd9"]
    return b"".join(out)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


# ------------------------------------------------------------- JPEG decoding
#
# `decode_jpeg` gives the pixels PIL gives (``np.asarray(Image.open(f))``),
# which libjpeg-turbo decodes at its defaults: the ISLOW integer IDCT, fancy
# (triangle) upsampling, the fixed-point YCbCr -> RGB tables.  Each stage
# below copies that arithmetic.  The entropy decoding runs in three steps: a
# table lookup of the Huffman code at every bit offset of the scan at once
# (numpy), a walk that takes one symbol a step through those tables (plain
# Python lists: the only serial part), then the coefficients' amplitude bits
# read at the walked offsets (numpy again).

_NATURAL = np.argsort(_ZIGZAG)  # zig-zag position of each natural index
_REFUSED_MARKERS = {
    0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)",
    0xC7: "hierarchical (SOF7)", 0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded (SOF10)",
    0xCB: "arithmetic-coded (SOF11)", 0xCC: "arithmetic-coded (DAC)", 0xCD: "arithmetic-coded (SOF13)",
    0xCE: "arithmetic-coded (SOF14)", 0xCF: "arithmetic-coded (SOF15)", 0xDC: "DNL-marker",
    0xDE: "hierarchical (DHP)", 0xDF: "hierarchical (EXP)",
}

def _idct_blocks(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Dequantise and inverse-transform blocks ``(..., 64)`` (natural order):
    the columns first, then the rows; the result is masked to 10 bits and
    passed through libjpeg's range-limit table (``+128``, clamped to
    [0, 255], the mask wrapping values outside [-512, 511]) -> ``(..., 8, 8)``
    uint8."""
    x = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(coef.shape[:-1] + (8, 8))
    ws = _islow_pass(np.swapaxes(x, -1, -2), _IDCT, 13 - 2)  # columns: (..., col, row)
    out = _islow_pass(np.swapaxes(ws, -1, -2), _IDCT, 13 + 2 + 3) & 1023  # rows: (..., row, col)
    out = np.where(out >= 512, out - 1024, out) + 128
    return np.clip(out, 0, 255).astype(np.uint8)


class _Huffman:
    """One DHT table as lookups on the 16-bit window that starts at a bit
    offset: ``code`` is ``length << 8 | symbol`` of the code found there
    (length 0 where no code of the table starts), and the walk's tables
    are derived from it: ``dc_adv`` (the bits a DC code and its amplitude
    take), ``ac_adv`` and ``ac_kinc`` (an AC code's bits with its amplitude,
    and how far it moves the coefficient index, 64 for an end of block)."""

    def __init__(self, counts, symbols):
        lut = np.zeros(65536, np.int32)
        code, k = 0, 0
        for n_bits, n in enumerate(counts, start=1):
            for _ in range(n):
                if code >= 1 << n_bits:
                    raise ValueError("JPEG Huffman table with more codes than its lengths allow")
                lo = code << (16 - n_bits)
                lut[lo:lo + (1 << (16 - n_bits))] = n_bits << 8 | symbols[k]
                code += 1
                k += 1
            code <<= 1
        self.code = lut
        ln, sy = lut >> 8, lut & 255
        self.dc_adv = np.minimum(ln + sy, 255).astype(np.uint8)
        self.ac_adv = (ln + (sy & 15)).astype(np.uint8)
        self.ac_kinc = _kinc(sy, eob=64).astype(np.uint8)


def _bits_at(win: np.ndarray, pos: np.ndarray, n: np.ndarray) -> np.ndarray:
    """The ``n`` (0-16) bits of the scan at each bit offset ``pos``, from
    the 16-bit windows."""
    return (win[pos] >> (16 - n)) & ((1 << n) - 1)


def _kinc(sym: np.ndarray, eob) -> np.ndarray:
    """How far an AC symbol moves the coefficient index: ``run + 1`` for a
    coefficient, 16 for ZRL, ``eob`` for an end of band."""
    s, r = sym & 15, sym >> 4
    return np.where(s > 0, r + 1, np.where(r == 15, 16, eob))


def _extend(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """T.81's EXTEND: ``s`` amplitude bits -> the signed value."""
    return np.where((s > 0) & (v < (1 << np.maximum(s - 1, 0))), v - (1 << s) + 1, v)


class _Scan:
    """The entropy-coded data of one scan: its bytes un-stuffed, with each
    restart interval starting on a byte of its own; the 16-bit window at
    every bit offset."""

    def __init__(self, data: bytes, start: int, end: int):
        raw = np.frombuffer(data, np.uint8, end - start, start)
        ff = np.flatnonzero(raw[:-1] == 0xFF)
        rst = ff[(raw[ff + 1] >= 0xD0) & (raw[ff + 1] <= 0xD7)]
        bounds = [0] + [b for r in rst for b in (r, r + 2)] + [len(raw)]
        parts, self.seg_start, self.seg_end = [], [], []
        nbytes = 0
        for a, b in zip(bounds[::2], bounds[1::2]):
            seg = raw[a:b]
            keep = np.ones(len(seg), bool)
            keep[1:] = ~((seg[:-1] == 0xFF) & (seg[1:] == 0))
            seg = seg[keep]
            parts.append(seg)
            self.seg_start.append(8 * nbytes)
            nbytes += len(seg)
            self.seg_end.append(8 * nbytes)
        b = np.concatenate(parts + [np.zeros(8, np.uint8)]).astype(np.int64)
        w24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
        self.nbits = 8 * nbytes
        self.win = ((w24[:nbytes + 2, None] >> (8 - np.arange(8))) & 0xFFFF).reshape(-1).astype(np.int32)

    def table(self, lut: np.ndarray) -> bytes:
        """A per-window lookup (uint8, 65536 entries) at every bit offset, as
        ``bytes``: the walk indexes it (faster to make than a list, and each
        entry is a cached small int)."""
        return lut.take(self.win).tobytes()

    def check_end(self, seg: int, p: int) -> None:
        if p > self.seg_end[seg]:
            raise ValueError("JPEG scan data ends before its blocks do (truncated or corrupt file)")


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None  # latched at the component's first scan
        self.coef = None   # (rows, cols, 64) int32, zig-zag order: a view of the decoder's store
        self.bits = [-1] * 64  # successive approximation: the Al each coefficient is known to


class _JpegDecoder:
    def __init__(self, data: bytes):
        self.data = data
        self.qt: dict[int, np.ndarray] = {}
        self.dc: dict[int, tuple] = {}
        self.ac: dict[int, tuple] = {}
        self.restart = 0
        self.jfif = False
        self.adobe = None
        self.comps: list[_Component] = []
        self.progressive = False
        self.scans = 0

    # ----- markers
    def _markers(self):
        """Each marker segment from SOI to EOI as ``(marker, body)``; ``self.pos``
        is just past the segment, and a consumer that reads a scan's entropy-
        coded data moves it past that data.  Fill bytes, restarts and TEM are
        skipped; a file that ends before EOI raises."""
        data, n = self.data, len(self.data)
        if n < 4 or data[:2] != b"\xff\xd8":
            raise ValueError("not a JPEG file (no SOI marker)")
        self.pos = 2
        while True:
            pos = self.pos
            while pos < n and data[pos] != 0xFF:
                pos += 1
            while pos < n and data[pos] == 0xFF:
                pos += 1
            if pos >= n:
                raise ValueError("truncated JPEG file: it ends before its EOI marker")
            m = data[pos]
            pos += 1
            if m == 0xD9:
                return
            if 0xD0 <= m <= 0xD7 or m == 0x01:
                self.pos = pos
                continue
            if pos + 2 > n or pos + ((data[pos] << 8) | data[pos + 1]) > n:
                raise ValueError("truncated JPEG file: a marker segment runs past its end")
            length = (data[pos] << 8) | data[pos + 1]
            self.pos = pos + length
            yield m, data[pos + 2:pos + length]

    def size(self) -> tuple[int, int]:
        """``(width, height)`` from the first frame header (any SOF, refused
        kinds too), read without decoding."""
        for m, body in self._markers():
            if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                return (body[3] << 8) | body[4], (body[1] << 8) | body[2]
        raise ValueError("JPEG without a frame header")

    def run(self) -> np.ndarray:
        for m, body in self._markers():
            if m in _REFUSED_MARKERS:
                raise ValueError(f"{_REFUSED_MARKERS[m]} JPEG is not decoded (baseline, extended and "
                                 "progressive Huffman only)")
            if m in (0xC0, 0xC1, 0xC2):
                self._frame(m, body)
            elif m == 0xC4:
                self._huffman(body)
            elif m == 0xDB:
                self._quant(body)
            elif m == 0xDD:
                self.restart = (body[0] << 8) | body[1]
            elif m == 0xE0 and len(body) >= 14 and body[:5] == b"JFIF\x00":
                self.jfif = True
            elif m == 0xEE and len(body) >= 12 and body[:5] == b"Adobe":
                self.adobe = body[11]
            elif m == 0xDA:
                self.pos = self._scan(body, self.pos)
        if not self.comps or not self.scans:
            raise ValueError("JPEG file without a frame or a scan")
        return self._pixels()

    def _frame(self, marker: int, body: bytes) -> None:
        precision, h, w, nc = body[0], (body[1] << 8) | body[2], (body[3] << 8) | body[4], body[5]
        if precision != 8:
            raise ValueError(f"{precision}-bit JPEG is not decoded (8-bit samples only)")
        if nc == 4 and self.adobe not in (None, 0):
            raise ValueError(_YCCK_REFUSAL)
        if nc not in (1, 3, 4):
            raise ValueError(f"JPEG with {nc} components is not decoded (1, 3 or 4)")
        if h == 0:
            raise ValueError("JPEG with a DNL-defined height is not decoded")
        self.height, self.width = h, w
        self.progressive = marker == 0xC2
        for i in range(nc):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                raise ValueError(f"JPEG sampling factors {hv >> 4}x{hv & 15} outside 1-4")
            self.comps.append(_Component(cid, hv >> 4, hv & 15, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-w // (8 * self.hmax))
        self.mcuy = -(-h // (8 * self.vmax))
        sizes = [self.mcuy * c.v * self.mcux * c.h * 64 for c in self.comps]
        self.coef = np.zeros(sum(sizes), np.int32)  # every component's blocks, one flat store
        for c, start in zip(self.comps, np.cumsum([0] + sizes[:-1]).tolist()):
            if self.hmax % c.h or self.vmax % c.v:
                raise ValueError("JPEG with fractional sampling ratios is not decoded")
            c.offset = start
            c.coef = self.coef[start:start + sizes[self.comps.index(c)]].reshape(self.mcuy * c.v, self.mcux * c.h, 64)
            c.dw = -(-w * c.h // self.hmax)  # the downsampled size
            c.dh = -(-h * c.v // self.vmax)

    def _huffman(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            tc_th = body[pos]
            counts = list(body[pos + 1:pos + 17])
            symbols = list(body[pos + 17:pos + 17 + sum(counts)])
            pos += 17 + sum(counts)
            (self.ac if tc_th >> 4 else self.dc)[tc_th & 15] = _Huffman(counts, symbols)

    def _quant(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            pq, tq = body[pos] >> 4, body[pos] & 15
            if pq:
                zz = np.frombuffer(body, ">u2", 64, pos + 1).astype(np.int64)
                pos += 129
            else:
                zz = np.frombuffer(body, np.uint8, 64, pos + 1).astype(np.int64)
                pos += 65
            self.qt[tq] = zz[_NATURAL]  # natural order

    # ----- scans
    def _scan(self, body: bytes, pos: int) -> int:
        if not self.comps:
            raise ValueError("JPEG scan before its frame header")
        ns = body[0]
        by_id = {c.id: c for c in self.comps}
        comps, tabs = [], []
        for i in range(ns):
            comp = by_id.get(body[1 + 2 * i])
            if comp is None:
                raise ValueError("JPEG scan names a component the frame lacks")
            comps.append(comp)
            tabs.append((body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15))
        ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
        for c in comps:
            if c.quant is None:
                if c.tq not in self.qt:
                    raise ValueError("JPEG component without its quantisation table")
                c.quant = self.qt[c.tq]
        # the scan runs to the next marker that is not a restart (FF00 is a stuffed FF)
        buf = np.frombuffer(self.data, np.uint8)
        ff = pos + np.flatnonzero(buf[pos:-1] == 0xFF)
        nxt = buf[ff + 1]
        ends = ff[(nxt != 0) & ((nxt < 0xD0) | (nxt > 0xD7))]
        if not len(ends):
            raise ValueError("truncated JPEG file: its last scan has no end")
        scan = _Scan(self.data, pos, int(ends[0]))
        if not self.progressive:
            ss, se, ah, al = 0, 63, 0, 0
        blocks = self._block_order(comps)
        try:
            if ss == 0 and ah == 0:
                self._dc_first(scan, comps, tabs, blocks, al, with_ac=not self.progressive)
            elif ss == 0:
                self._dc_refine(scan, blocks, al)
            elif ah == 0:
                self._ac_first(scan, tabs[0][1], blocks, ss, se, al)
            else:
                self._ac_refine(scan, tabs[0][1], blocks, ss, se, al)
        except (IndexError, KeyError) as err:
            raise ValueError(f"corrupt JPEG scan data ({type(err).__name__}: a code or table that is not "
                             "there)") from None
        for c in comps:
            for k in range(ss, se + 1):
                c.bits[k] = al
        self.scans += 1
        return int(ends[0])

    def _block_order(self, comps):
        """Blocks of a scan in the order they are coded: ``(slot, at, mcu)``
        arrays: the scan component (``slot``), where the block's 64
        coefficients start in the store, and its MCU."""
        if len(comps) == 1:  # non-interleaved: one block an MCU, the component's own grid
            c = comps[0]
            rows, cols = -(-c.dh // 8), -(-c.dw // 8)
            r, q = np.divmod(np.arange(rows * cols), cols)
            return np.zeros(rows * cols, np.int64), c.offset + (r * c.coef.shape[1] + q) * 64, np.arange(rows * cols)
        slot, dy, dx = [], [], []
        for i, c in enumerate(comps):
            for y in range(c.v):
                for x in range(c.h):
                    slot.append(i)
                    dy.append(y)
                    dx.append(x)
        slot, dy, dx = np.array(slot), np.array(dy), np.array(dx)
        hs = np.array([c.h for c in comps])[slot]
        vs = np.array([c.v for c in comps])[slot]
        my, mx = np.divmod(np.arange(self.mcuy * self.mcux), self.mcux)
        rows, cols = (my[:, None] * vs + dy).reshape(-1), (mx[:, None] * hs + dx).reshape(-1)
        slot = np.tile(slot, len(my))
        offset = np.array([c.offset for c in comps])[slot]
        width = np.array([c.coef.shape[1] for c in comps])[slot]
        return slot, offset + (rows * width + cols) * 64, np.repeat(np.arange(len(my)), len(dy))

    def _segments(self, mcu: np.ndarray) -> np.ndarray:
        return mcu // self.restart if self.restart else np.zeros_like(mcu)

    def _dc_first(self, scan, comps, tabs, blocks, al, with_ac):
        """A sequential scan (``with_ac``) or a progressive DC first scan.
        The walk keeps only each block's offset; the AC symbols are found
        again afterwards, all blocks at once (`_place_ac`)."""
        slot, at, mcu = blocks
        dadv = [scan.table(self.dc[t[0]].dc_adv) for t in tabs]
        if with_ac:
            aadv = [scan.table(self.ac[t[1]].ac_adv) for t in tabs]
            akinc = [scan.table(self.ac[t[1]].ac_kinc) for t in tabs]
        pattern = slot[:int(np.sum(mcu == 0))].tolist()
        seq = [(dadv[i], aadv[i], akinc[i]) if with_ac else dadv[i] for i in pattern]
        n_mcu = int(mcu[-1]) + 1
        dpos = []
        dapp = dpos.append
        seg, p, every = 0, scan.seg_start[0], self.restart or n_mcu + 1
        for m in range(n_mcu):
            if m and m % every == 0:
                scan.check_end(seg, p)
                seg += 1
                p = scan.seg_start[seg]
            if with_ac:
                for dad, adv, kinc in seq:
                    dapp(p)
                    p += dad[p]
                    k = 1
                    while k < 64:
                        k += kinc[p]
                        p += adv[p]
            else:
                for dad in seq:
                    dapp(p)
                    p += dad[p]
        scan.check_end(seg, p)
        dpos = np.array(dpos, np.int64)
        code = np.stack([self.dc[t[0]].code for t in tabs])[slot, scan.win[dpos]]
        ln, sy = code >> 8, code & 255
        if (ln == 0).any() or (sy > 11).any():
            raise ValueError("corrupt JPEG scan data (a DC code not in its table)")
        diff = _extend(_bits_at(scan.win, dpos + ln, sy), sy)
        # the DC values: the differences summed along each component's blocks, restarting at each interval
        segs = self._segments(mcu)
        for i in range(len(comps)):
            sel = slot == i
            d, sg = diff[sel], segs[sel]
            total = np.cumsum(d)
            starts = np.flatnonzero(np.r_[True, sg[1:] != sg[:-1]])
            base = np.repeat(total[starts] - d[starts], np.diff(np.r_[starts, len(d)]))
            self.coef[at[sel]] = (total - base) << al
        if with_ac:
            self._place_ac(scan, [t[1] for t in tabs], blocks, dpos + ln + sy, 1, 63, 0, aadv, akinc)

    def _place_ac(self, scan, tables, blocks, start, ss, se, al, advs, kincs):
        """Decode the AC symbols of band ``ss..se`` of every block whose
        symbols start at bit ``start`` (``-1``: none, an end-of-band run
        covers the block) and write the coefficients.  The blocks' chains
        are followed again through the walk's tables (``advs``, ``kincs``:
        one a scan component), one symbol of every block a step, then the
        symbols and their amplitudes are read at the offsets found."""
        slot, first, _ = blocks
        n = len(scan.win)
        adv = np.concatenate([np.frombuffer(a, np.uint8) for a in advs])
        kinc = np.concatenate([np.frombuffer(k, np.uint8) for k in kincs])
        blk = np.flatnonzero(start >= 0)
        pos, k, base = start[blk], np.full(len(blk), ss, np.int64), slot[blk] * n
        found = []
        while len(blk):
            found.append((blk, pos, k))
            at = pos + base
            k = k + kinc[at]
            pos = pos + adv[at]
            alive = k <= se
            if not alive.all():
                blk, pos, k, base = blk[alive], pos[alive], k[alive], base[alive]
        if not found:
            return
        b, at, k = (np.concatenate(v) for v in zip(*found))
        code = np.stack([self.ac[t].code for t in tables])[slot[b], scan.win[at]]
        ln, sy = code >> 8, code & 255
        if (ln == 0).any():
            raise ValueError("corrupt JPEG scan data (an AC code not in its table)")
        s, r = sy & 15, sy >> 4
        nz = s > 0
        b, zz, s = b[nz], (k + r)[nz], s[nz]
        if len(zz) and zz.max() > se:
            raise ValueError("corrupt JPEG scan data (a coefficient past the end of its band)")
        self.coef[first[b] + zz] = _extend(_bits_at(scan.win, at[nz] + ln[nz], s), s) << al

    def _dc_refine(self, scan, blocks, al):
        """A progressive DC refinement scan: one bit a block."""
        _, at, mcu = blocks
        segs = self._segments(mcu)
        starts = np.flatnonzero(np.r_[True, segs[1:] != segs[:-1]])
        within = np.arange(len(mcu)) - np.repeat(starts, np.diff(np.r_[starts, len(mcu)]))
        pos = np.array(scan.seg_start)[segs] + within
        for s, last in enumerate(pos[np.r_[starts[1:], len(pos)] - 1].tolist()):
            scan.check_end(s, last + 1)
        self.coef[at] |= (_bits_at(scan.win, pos, np.ones_like(pos)) << al).astype(np.int32)

    def _ac_first(self, scan, table, blocks, ss, se, al):
        """A progressive AC first scan (one component, band ``ss..se``) with
        its end-of-band runs."""
        code = self.ac[table].code
        sy = code & 255
        s, r = sy & 15, sy >> 4
        eob = (s == 0) & (r < 15)
        adv = scan.table(((code >> 8) + np.where(eob, r, s)).astype(np.uint8))
        kinc = scan.table(_kinc(sy, eob=128 + r).astype(np.uint8))  # EOBr: 128 + r, past any band
        n = len(blocks[0])
        start = np.full(n, -1, np.int64)
        seg, p, eobrun, every = 0, scan.seg_start[0], 0, self.restart or n + 1
        for b in range(n):
            if b and b % every == 0:
                scan.check_end(seg, p)
                seg += 1
                p, eobrun = scan.seg_start[seg], 0
            if eobrun:
                eobrun -= 1
                continue
            start[b] = p
            k = ss
            while k <= se:
                q = p
                k += kinc[q]
                p += adv[q]
            if k >= 128:  # EOBr ends this block and 2^r - 1 + (r more bits) after it
                run = kinc[q] - 128
                at = q + (int(code[scan.win[q]]) >> 8)
                eobrun = (1 << run) - 1 + (int(scan.win[at]) >> (16 - run) if run else 0)
        scan.check_end(seg, p)
        self._place_ac(scan, [table], blocks, start, ss, se, al, [adv], [kinc])

    def _ac_refine(self, scan, table, blocks, ss, se, al):
        """A progressive AC refinement scan, walked symbol by symbol and
        coefficient by coefficient (jdphuff.c's ``decode_mcu_AC_refine``)."""
        at = blocks[1][:, None] + np.arange(64)
        code = self.ac[table].code
        lens, syms = scan.table((code >> 8).astype(np.uint8)), scan.table((code & 255).astype(np.uint8))
        bits = (scan.win >> 15).astype(np.uint8).tobytes()
        coef = self.coef[at].tolist()
        p1, m1 = 1 << al, -1 << al
        seg, p, eobrun, every = 0, scan.seg_start[0], 0, self.restart or len(coef) + 1
        for b, blk in enumerate(coef):
            if b and b % every == 0:
                scan.check_end(seg, p)
                seg += 1
                p, eobrun = scan.seg_start[seg], 0
            k = ss
            if not eobrun:
                while k <= se:
                    if not lens[p]:
                        raise ValueError("corrupt JPEG scan data (an AC code not in its table)")
                    rs = syms[p]
                    p += lens[p]
                    r, s = rs >> 4, rs & 15
                    if s:
                        s = p1 if bits[p] else m1
                        p += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += int(scan.win[p]) >> (16 - r)
                            p += r
                        break
                    while k <= se:  # skip r zero coefficients, refining the nonzero ones passed
                        c = blk[k]
                        if c:
                            if bits[p] and not c & p1:
                                blk[k] = c + (p1 if c >= 0 else m1)
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s and k <= se:
                        blk[k] = s
                    k += 1
            if eobrun:
                while k <= se:
                    c = blk[k]
                    if c:
                        if bits[p] and not c & p1:
                            blk[k] = c + (p1 if c >= 0 else m1)
                        p += 1
                    k += 1
                eobrun -= 1
        scan.check_end(seg, p)
        self.coef[at] = np.array(coef, np.int32).reshape(-1, 64)

    # ----- samples
    def _pixels(self) -> np.ndarray:
        if self.progressive and any(c.bits[k] != 0 for c in self.comps for k in range(10)):
            raise ValueError("progressive JPEG whose scans leave a low coefficient unrefined is not decoded "
                             "(libjpeg smooths such blocks)")
        planes = []
        for c in self.comps:
            if c.quant is None:
                raise ValueError("JPEG component that no scan codes")
            blocks = _idct_blocks(c.coef[..., _NATURAL], c.quant)  # zig-zag -> natural order
            rows, cols = blocks.shape[:2]
            plane = blocks.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)[:c.dh, :c.dw]
            planes.append(_upsample(plane, self.hmax // c.h, self.vmax // c.v)[:self.height, :self.width])
        if len(planes) == 1:
            return planes[0]
        if len(planes) == 4:
            # libjpeg: four components are CMYK unless an Adobe marker says
            # YCCK (transform 1 or 2); PIL reads them inverted (Adobe's inks)
            if self.adobe not in (None, 0):
                raise ValueError(_YCCK_REFUSAL)
            return _cmyk_to_rgb(*planes)
        # libjpeg's colour space rule: JFIF means YCbCr, else an Adobe marker's
        # transform (0 RGB, else YCbCr), else component ids R, G, B mean RGB
        if self.jfif:
            rgb = False
        elif self.adobe is not None:
            rgb = self.adobe == 0
        else:
            rgb = [c.id for c in self.comps] == [82, 71, 66]
        if rgb:
            return np.stack(planes, axis=-1)
        return _ycc_to_rgb(*planes)


def _upsample(plane: np.ndarray, hx: int, vx: int) -> np.ndarray:
    """libjpeg-turbo's upsampler of one component (``jdsample.c``): the
    fancy (triangle) filters for 2x1 and 2x2 when the component is wider
    than 2 samples, and for 1x2; sample replication otherwise."""
    if hx == 1 and vx == 1:
        return plane
    x = plane.astype(np.int32)
    dh, dw = x.shape
    if hx == 2 and vx == 1 and dw > 2:
        out = np.empty((dh, 2 * dw), np.int32)
        t = 3 * x
        out[:, 0] = x[:, 0]
        out[:, 2::2] = (t[:, 1:] + x[:, :-1] + 1) >> 2
        out[:, 1:-1:2] = (t[:, :-1] + x[:, 1:] + 2) >> 2
        out[:, -1] = x[:, -1]
        return out.astype(np.uint8)
    if vx == 2 and hx in (1, 2) and (hx == 1 or dw > 2):
        above = np.concatenate([x[:1], x[:-1]])  # the first row is its own row above
        below = np.concatenate([x[1:], x[-1:]])  # the last real row is its own row below
        if hx == 1:
            out = np.empty((2 * dh, dw), np.int32)
            out[0::2] = (3 * x + above + 1) >> 2
            out[1::2] = (3 * x + below + 2) >> 2
            return out.astype(np.uint8)
        out = np.empty((2 * dh, 2 * dw), np.int32)
        for v, s in enumerate((3 * x + above, 3 * x + below)):
            rows = out[v::2]
            t = 3 * s
            rows[:, 0] = (4 * s[:, 0] + 8) >> 4
            rows[:, 2::2] = (t[:, 1:] + s[:, :-1] + 8) >> 4
            rows[:, 1:-1:2] = (t[:, :-1] + s[:, 1:] + 7) >> 4
            rows[:, -1] = (4 * s[:, -1] + 7) >> 4
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, vx, axis=0), hx, axis=1)


# jdcolor.c: SCALEBITS = 16, FIX(x) = int(x * 2^16 + 0.5), ONE_HALF = 2^15
_FIX_1_402, _FIX_1_772 = 91881, 116130
_FIX_0_344, _FIX_0_714 = 22554, 46802


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ``ycc_rgb_convert`` (its tables, computed in place)."""
    y = y.astype(np.int32)  # every product and sum stays below 2^25
    xb = cb.astype(np.int32) - 128
    xr = cr.astype(np.int32) - 128
    r = y + ((_FIX_1_402 * xr + 32768) >> 16)
    g = y + ((-_FIX_0_344 * xb + 32768 - _FIX_0_714 * xr) >> 16)
    b = y + ((_FIX_1_772 * xb + 32768) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


_YCCK_REFUSAL = ("four-component YCCK JPEG (Adobe transform 1 or 2) is not decoded: only Adobe CMYK "
                 "(transform 0 or no Adobe marker) is")


def _cmyk_to_rgb(c: np.ndarray, m: np.ndarray, y: np.ndarray, k: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of the stored (inverted) inks: with ``nk =
    255 - K = k``, each channel is ``nk - nk * (255 - ink) / 255`` in
    Pillow's rounded ``MULDIV255``."""
    nk = k.astype(np.int32)[..., None]
    ink = 255 - np.stack([c, m, y], axis=-1).astype(np.int32)
    t = ink * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> the pixels PIL reads from them: ``(H, W)`` uint8 for a
    one-component file, ``(H, W, 3)`` RGB for three (YCbCr converted; an
    Adobe transform-0 or an ``R``,``G``,``B`` file is RGB as stored, as
    libjpeg decides it) and for an Adobe CMYK file (four components, PIL's
    ``convert("RGB")`` of its inks).  Takes baseline and extended sequential
    and progressive Huffman JPEG with restart intervals and any sampling
    factors 1-4; raises ``ValueError`` naming what it refuses: arithmetic
    coding, 12-bit samples, lossless and hierarchical files, YCCK, DNL, a
    progressive file left unrefined, and a truncated file."""
    return _JpegDecoder(bytes(data)).run()


# ---------------------------------------------------------------- read_image

def read_image(path: str) -> np.ndarray:
    """A frame or map image from disk: ``.png`` (`decode_png`), ``.jpg`` /
    ``.jpeg`` (`decode_jpeg`: PIL's pixels) or ``.npy`` (an array saved with
    ``np.save``); any other extension raises ``ValueError``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path)
    if ext not in (".png", ".jpg", ".jpeg"):
        raise ValueError(f"{path}: unsupported image format {ext!r} (PNG, JPEG or .npy)")
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data) if ext == ".png" else decode_jpeg(data)
    except ValueError as err:
        raise ValueError(f"{path}: {err}") from None


def image_size(path: str) -> tuple[int, int]:
    """``(width, height)`` of a PNG (its IHDR) or JPEG (its frame header)
    file, read without decoding it: what PIL's ``Image.open(path).size``
    gives."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        w, h = struct.unpack(">II", data[16:24])
        return w, h
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: neither PNG nor JPEG")
    try:
        return _JpegDecoder(data).size()
    except ValueError as err:
        raise ValueError(f"{path}: {err}") from None


def to_rgb(img: np.ndarray) -> np.ndarray:
    """A decoded image as uint8 RGB, as PIL's ``convert("RGB")`` makes it
    from gray (replicated), gray + alpha and RGBA (the alpha dropped)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"8-bit images only, got {img.dtype}")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


# --------------------------------------------------- PIL's 8-bit resampling
#
# ``Image.resize`` of a uint8 gray or RGB image (Pillow's Resample.c): each
# axis whose size changes is resampled in turn, the horizontal one first,
# with the filter's support stretched by the downscale factor, weights in
# 22-bit fixed point and every pass rounded and clipped to uint8.

_PRECISION_BITS = 32 - 8 - 2


def _bilinear_filter(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


_FILTERS = {"bilinear": (_bilinear_filter, 1.0), "bicubic": (_bicubic_filter, 2.0)}


def _resample_coeffs(in_size: int, out_size: int, kind: str):
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``: each
    output's first input and the fixed-point weights ``(out, ksize)``."""
    fn, support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    centers = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(centers - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(centers + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = fn((taps[None, :] + xmin[:, None] - centers[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    kk = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << _PRECISION_BITS)).astype(np.int64)
    return xmin, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int, kind: str) -> np.ndarray:
    """One pass of the 8-bit resample along ``axis``."""
    in_size = img.shape[axis]
    xmin, kk = _resample_coeffs(in_size, out_size, kind)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1])[None, :], in_size - 1)  # zero weights past xmax
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(kk.shape[1]):
        acc += src[idx[:, t]] * kk[:, t].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resize(img: np.ndarray, width: int, height: int, kind: str) -> np.ndarray:
    out = np.array(img, np.uint8)
    if out.shape[1] != width:
        out = _resample_axis(out, width, 1, kind)
    if out.shape[0] != height:
        out = _resample_axis(out, height, 0, kind)
    return out


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's ``Image.resize((width, height), Image.BILINEAR)`` of a uint8
    ``(H, W[, C])`` image (an image of the same size comes back as a
    copy)."""
    return _resize(img, width, height, "bilinear")


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's ``Image.resize((width, height))`` of a uint8 ``(H, W[, C])``
    image: its default filter, bicubic (``a = -0.5``, support 2)."""
    return _resize(img, width, height, "bicubic")


def write_image(path: str, img: np.ndarray) -> None:
    """Save a uint8 gray or RGB image by its extension: PNG, or JPEG at
    PIL's save defaults (quality 75, 4:2:0)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        data = encode_jpeg(img, quality=75)
    elif ext == ".png":
        data = encode_png(np.asarray(img, np.uint8))
    else:
        raise ValueError(f"{path}: unsupported image format {ext!r} (PNG or JPEG)")
    with open(path, "wb") as f:
        f.write(data)


# ------------------------------------------------------------ image helpers
# (the JAX package's ``utils/images.py``, with the codecs and resamplers above
# in place of PIL)

def resize_images(src_dir: str, dst_dir: str, size: tuple[int, int]) -> int:
    """Resize every ``.jpg``/``.jpeg``/``.png`` in ``src_dir`` to ``size``
    ``(w, h)`` (RGB, bicubic) into ``dst_dir`` under the same name;
    returns the count."""
    os.makedirs(dst_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(src_dir)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        img = to_rgb(read_image(os.path.join(src_dir, name)))
        write_image(os.path.join(dst_dir, name), resize_bicubic(img, int(size[0]), int(size[1])))
        n += 1
    return n


def _as_uint8(img) -> np.ndarray:
    arr = np.asarray(img)
    arr = arr if arr.dtype == np.uint8 else arr.astype(np.uint8)
    if not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"a gray (H, W) or RGB (H, W, 3) image, not {arr.shape}")
    return arr


def resize_to_width(img: np.ndarray, max_width: int) -> tuple[np.ndarray, float]:
    """Shrink an image so its width is at most ``max_width``: the resized
    array and the downscale factor (1 for an image already narrow enough,
    which comes back as a copy).  The factor maps display clicks back to
    the image's pixels."""
    arr = np.asarray(img)
    h0, w0 = arr.shape[:2]
    if w0 <= max_width:
        return arr.copy(), 1.0
    factor = w0 / max_width
    return resize_bicubic(_as_uint8(arr), int(w0 / factor), int(h0 / factor)), factor


def resize_to_width_exact(img: np.ndarray, width: int) -> tuple[np.ndarray, float]:
    """Scale an image to exactly ``width`` (up or down), keeping its aspect:
    the array and the factor ``w0 / width``."""
    arr = np.asarray(img)
    h0, w0 = arr.shape[:2]
    factor = w0 / width
    return resize_bicubic(_as_uint8(arr), width, max(1, round(h0 / factor))), factor


def load_resized(path: str, size: tuple[int, int]) -> np.ndarray:
    """An image file as RGB resized to ``(w, h)``."""
    return resize_bicubic(to_rgb(read_image(path)), int(size[0]), int(size[1]))


def resize_frame(img: np.ndarray, size: tuple[int, int], bgr_to_rgb: bool = False) -> np.ndarray:
    """One video frame resized to exactly ``(w, h)``, its channel order
    optionally swapped first."""
    arr = np.asarray(img)
    if bgr_to_rgb and arr.ndim == 3:
        arr = arr[..., ::-1]
    return resize_bicubic(_as_uint8(arr), int(size[0]), int(size[1]))


def images_to_video(frames, dst_path: str, fps: float = 10.0, size: tuple[int, int] | None = None,
                    quality: int = 90) -> int:
    """Write images to an MJPEG ``.avi``; returns the frame count.

    ``frames`` is an iterable of RGB uint8 arrays and/or image paths (or a
    directory, expanded by `list_dir_paths`).  Every frame is resized to
    ``size`` (default: the first frame's), encoded by `encode_jpeg` at
    ``quality`` and wrapped in a RIFF/AVI container (``avih``/``strh``/
    ``strf`` headers, ``00dc`` chunks, an ``idx1`` key-frame index)."""
    if isinstance(frames, str):
        frames = list_dir_paths(frames)
    blobs: list[bytes] = []
    w = h = 0
    for f in frames:
        im = to_rgb(read_image(f) if isinstance(f, str) else np.asarray(f, np.uint8))
        if size is None:
            size = (im.shape[1], im.shape[0])
        if (im.shape[1], im.shape[0]) != tuple(size):
            im = resize_bicubic(im, int(size[0]), int(size[1]))
        h, w = im.shape[:2]
        blobs.append(encode_jpeg(im, quality=quality))
    if not blobs:
        raise ValueError("images_to_video: no frames")

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return tag + struct.pack("<I", len(payload)) + payload + (b"\0" if len(payload) & 1 else b"")

    usec = int(round(1_000_000 / float(fps)))
    maxb = max(len(b) for b in blobs)
    avih = struct.pack("<14I", usec, maxb * int(fps), 0, 0x10, len(blobs), 0, 1, maxb, w, h, 0, 0, 0, 0)
    strh = b"vids" + b"MJPG" + struct.pack("<IHHIIIIIIII4H", 0, 0, 0, 0, 1, int(round(fps)),
                                           0, len(blobs), maxb, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    strl = b"LIST" + struct.pack("<I", 4 + len(chunk(b"strh", strh)) + len(chunk(b"strf", strf))) \
        + b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf)
    hdrl_body = b"hdrl" + chunk(b"avih", avih) + strl
    hdrl = b"LIST" + struct.pack("<I", len(hdrl_body)) + hdrl_body

    movi_chunks, idx, off = [], [], 4  # offsets count from the 'movi' tag
    for b in blobs:
        c = chunk(b"00dc", b)
        movi_chunks.append(c)
        idx.append(b"00dc" + struct.pack("<III", 0x10, off, len(b)))  # AVIIF_KEYFRAME
        off += len(c)
    movi_body = b"movi" + b"".join(movi_chunks)
    movi = b"LIST" + struct.pack("<I", len(movi_body)) + movi_body
    idx1 = chunk(b"idx1", b"".join(idx))

    riff_body = b"AVI " + hdrl + movi + idx1
    with open(dst_path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(riff_body)) + riff_body)
    return len(blobs)


def list_dir_paths(folder: str) -> list[str]:
    """Full paths of a directory's entries, sorted; [] when it is missing."""
    if not os.path.isdir(folder):
        return []
    return [os.path.join(folder, name) for name in sorted(os.listdir(folder))]


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """RGB [0, 255] -> HSV in OpenCV's ranges (H 0-179, S and V 0-255)."""
    arr = np.asarray(img, np.float32) / 255.0
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    mx = arr.max(-1)
    mn = arr.min(-1)
    diff = mx - mn + 1e-12
    h = np.zeros_like(mx)
    h = np.where(mx == r, (60 * ((g - b) / diff) + 360) % 360, h)
    h = np.where(mx == g, 60 * ((b - r) / diff) + 120, h)
    h = np.where(mx == b, 60 * ((r - g) / diff) + 240, h)
    s = np.where(mx > 0, diff / (mx + 1e-12), 0)
    return np.stack([h / 2.0, s * 255.0, mx * 255.0], axis=-1)


def hsv_mask(img: np.ndarray, lower, upper) -> np.ndarray:
    """Boolean mask of the pixels inside an HSV range."""
    hsv = rgb_to_hsv(img)
    lo = np.asarray(lower, np.float32)
    hi = np.asarray(upper, np.float32)
    return ((hsv >= lo) & (hsv <= hi)).all(-1)


def connected_regions(mask: np.ndarray):
    """The 4-connected regions of a boolean mask, in the order of their
    first pixel (row-major), found by flood fill: yields ``(labels, n, ys,
    xs)``, the label image so far, the region's label and its pixels."""
    labels = np.zeros(mask.shape, np.int32)
    h, w = mask.shape
    n = 0
    for y0, x0 in np.argwhere(mask):
        if labels[y0, x0]:
            continue
        n += 1
        labels[y0, x0] = n
        q = collections.deque([(y0, x0)])
        ys, xs = [y0], [x0]
        while q:
            y, x = q.popleft()
            for ny, nx in ((y + 1, x), (y - 1, x), (y, x + 1), (y, x - 1)):
                if 0 <= ny < h and 0 <= nx < w and mask[ny, nx] and not labels[ny, nx]:
                    labels[ny, nx] = n
                    ys.append(ny)
                    xs.append(nx)
                    q.append((ny, nx))
        yield labels, n, ys, xs


def hsv_edge_boxes(img: np.ndarray, lower, upper, min_area: int = 50):
    """Bounding boxes ``(x0, y0, x1, y1)`` of the 4-connected regions of an
    HSV mask with at least ``min_area`` pixels."""
    return [(min(xs), min(ys), max(xs) + 1, max(ys) + 1)
            for _, _, ys, xs in connected_regions(hsv_mask(img, lower, upper)) if len(ys) >= min_area]


def reset_directory(path: str) -> None:
    """Remove a directory and make it again, empty."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
