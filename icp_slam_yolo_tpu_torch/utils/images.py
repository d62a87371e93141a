"""Image codecs on numpy, ``zlib`` and ``struct`` alone: PNG in and out,
baseline JPEG out, and `read_image` for the frame and map files the port
reads (PNG and ``.npy``).

The machine the port serves from may have no imaging package, so the server's
``image/png`` and ``image/jpeg`` responses, the saved occupancy maps and the
replayed camera frames all go through this module.

* `encode_png` / `decode_png`: 8-bit gray, RGB and RGBA, no interlace; the
  decoder undoes all five row filters (what other writers' adaptive
  filtering produces).
* `encode_jpeg`: baseline sequential JPEG (ITU T.81), 4:2:0 or 4:4:4, the
  Annex K quantisation tables scaled by ``quality`` as libjpeg scales them
  and the Annex K Huffman tables; the 8 x 8 DCT is two matrix products.
  JPEG decoding is not here: `read_image` refuses ``.jpg`` by name.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------- PNG

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> colour type (gray, RGB, RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


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


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 ``(H, W)`` gray, ``(H, W, 2)`` gray + alpha,
    ``(H, W, 3)`` RGB or ``(H, W, 4)`` RGBA.  Takes 8-bit samples without
    interlace and any of the five row filters; raises ``ValueError`` for
    anything else (palette, 16-bit, interlaced)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS:
        raise ValueError(f"PNG with bit depth {depth} and colour type {color}: only 8-bit gray, gray + alpha, "
                         "RGB and RGBA are read")
    if interlace:
        raise ValueError("interlaced PNG is not read")
    bpp = _PNG_CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, the header asks for {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, row = raw[y, 0], raw[y, 1:]
        if kind == 0:
            cur = row
        elif kind == 1:  # Sub: a running sum of each channel along the row
            lanes = row.astype(np.int64).reshape(w, bpp)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(stride)
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
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


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


def _dct_matrix() -> np.ndarray:
    u, x = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    c = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


_DCT = _dct_matrix()


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """``(H, W)`` with both a multiple of 8 -> ``(H/8, W/8, 8, 8)``."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _coefficients(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Level-shifted DCT and quantisation of every block of a plane:
    ``(by, bx, 64)`` int64 in zig-zag order."""
    f = _DCT @ (_blocks(plane) - 128.0) @ _DCT.T
    return np.round(f / q).astype(np.int64).reshape(*f.shape[:2], 64)[..., _ZIGZAG]


def _magnitude(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """JPEG's size category of each value and its amplitude bits."""
    a = np.abs(v)
    size = np.zeros_like(a)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    bits = np.where(v >= 0, v, v + (1 << size) - 1)
    return size, bits


def _entropy_symbols(coef: np.ndarray, dc_table, ac_table):
    """The Huffman-coded symbols of blocks ``(n, 64)`` in the order they are
    written: ``(block, key, bits, length)`` with ``key`` the order inside a
    block (the DC difference, each coefficient's zero-run escapes and the
    coefficient, the end of block)."""
    dc_code, dc_len = _huffman_codes(dc_table)
    ac_code, ac_len = _huffman_codes(ac_table)
    n = len(coef)
    diff = np.diff(coef[:, 0], prepend=0)
    size, amp = _magnitude(diff)
    blocks = [np.arange(n)]
    keys = [np.zeros(n, np.int64)]
    bits = [(dc_code[size] << size) | amp]
    lens = [dc_len[size] + size]

    blk, pos = np.nonzero(coef[:, 1:])
    pos = pos + 1
    val = coef[blk, pos]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], pos[:-1]]))
    run = pos - prev - 1
    size, amp = _magnitude(val)
    sym = ((run & 15) << 4) | size
    blocks.append(blk)
    keys.append(4 * pos + 3)
    bits.append((ac_code[sym] << size) | amp)
    lens.append(ac_len[sym] + size)
    for j in range(3):  # runs of 16 zeros (ZRL) ahead of the coefficient
        m = run >= 16 * (j + 1)
        blocks.append(blk[m])
        keys.append(4 * pos[m] + j)
        bits.append(np.full(m.sum(), ac_code[0xF0]))
        lens.append(np.full(m.sum(), ac_len[0xF0]))
    last = np.zeros(n, np.int64)
    is_last = np.concatenate([first[1:], [True]]) if len(blk) else np.zeros(0, bool)
    last[blk[is_last]] = pos[is_last]
    eob = np.nonzero(last < 63)[0]
    blocks.append(eob)
    keys.append(np.full(len(eob), 4 * 64))
    bits.append(np.full(len(eob), ac_code[0x00]))
    lens.append(np.full(len(eob), ac_len[0x00]))
    return (np.concatenate(blocks), np.concatenate(keys), np.concatenate(bits), np.concatenate(lens))


def _pack_bits(bits: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate codes (MSB first), pad the last byte with ones and stuff a
    zero byte after every 0xFF."""
    width = 32
    shifts = np.arange(width - 1, -1, -1)
    matrix = ((bits[:, None] >> shifts[None]) & 1).astype(np.uint8)
    keep = shifts[None] < lens[:, None]
    stream = matrix[keep]
    pad = (-len(stream)) % 8
    stream = np.concatenate([stream, np.ones(pad, np.uint8)])
    out = np.packbits(stream)
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def _rgb_to_ycbcr(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return y, cb, cr


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
    padded = _pad_to(arr, mh * m, mw * m)

    if gray:
        y = _coefficients(padded.astype(np.float64), ql).reshape(-1, 64)
        groups = [(y, _DC_LUMA, _AC_LUMA, np.arange(len(y)))]
        comps = [(1, 0x11, 0)]
    else:
        yp, cb, cr = _rgb_to_ycbcr(padded)
        if m == 16:
            cb = cb.reshape(mh * 8, 2, mw * 8, 2).mean(axis=(1, 3))
            cr = cr.reshape(mh * 8, 2, mw * 8, 2).mean(axis=(1, 3))
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

    order, keys, bits, lens = [], [], [], []
    for coef, dct, act, emit in groups:
        rank = np.argsort(emit, kind="stable")  # DC differences run in the order blocks are written
        blk, key, b, ln = _entropy_symbols(coef[rank], dct, act)
        order.append(emit[rank][blk])
        keys.append(key)
        bits.append(b)
        lens.append(ln)
    order, keys = np.concatenate(order), np.concatenate(keys)
    sort = np.lexsort((keys, order))
    scan = _pack_bits(np.concatenate(bits)[sort], np.concatenate(lens)[sort])

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


# ---------------------------------------------------------------- read_image

def read_image(path: str) -> np.ndarray:
    """A frame or map image from disk: ``.png`` (through `decode_png`) or
    ``.npy`` (an array saved with ``np.save``).  JPEG is not decoded here:
    ``.jpg``/``.jpeg`` raises ``ValueError`` naming the format."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        with open(path, "rb") as f:
            return decode_png(f.read())
    if ext == ".npy":
        return np.load(path)
    if ext in (".jpg", ".jpeg"):
        raise ValueError(f"{path}: JPEG input is not read by the port (PNG or .npy frames only)")
    raise ValueError(f"{path}: unsupported image format {ext!r} (PNG or .npy)")
