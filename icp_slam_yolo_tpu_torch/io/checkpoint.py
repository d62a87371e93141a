"""Read the repo's model checkpoints: one msgpack file (as flax's
serialization writes it) with a JSON sidecar ``<path>.json``.

The port imports neither flax nor a msgpack package, so it decodes the format
itself: the msgpack types a checkpoint uses (maps, arrays, strings, binary,
integers, floats, booleans, nil) and flax's extension types: 1 is an ndarray,
packed as ``(shape, dtype name, bytes)``; 2 a complex number ``(re, im)``; 3
a numpy scalar, packed like an ndarray.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: the data ends inside a value")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ext(code: int, payload: memoryview):
    if code == 1 or code == 3:
        shape, dtype_name, buf = _unpack(_Reader(bytes(payload)))
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr if code == 1 else arr[()]
    if code == 2:
        re, im = _unpack(_Reader(bytes(payload)))
        return complex(re, im)
    raise ValueError(f"msgpack: unknown extension type {code}")


_INTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LEN = {0: ">B", 1: ">H", 2: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _unpack(r: _Reader):
    t = r.num(">B")
    if t <= 0x7f:
        return t
    if t >= 0xe0:
        return t - 0x100
    if 0x80 <= t <= 0x8f:
        return _map(r, t & 0x0f)
    if 0x90 <= t <= 0x9f:
        return [_unpack(r) for _ in range(t & 0x0f)]
    if 0xa0 <= t <= 0xbf:
        return bytes(r.take(t & 0x1f)).decode("utf-8")
    if t == 0xc0:
        return None
    if t == 0xc2:
        return False
    if t == 0xc3:
        return True
    if 0xc4 <= t <= 0xc6:
        return bytes(r.take(r.num(_LEN[t - 0xc4])))
    if 0xc7 <= t <= 0xc9:
        n = r.num(_LEN[t - 0xc7])
        code = r.num(">b")
        return _ext(code, r.take(n))
    if t == 0xca:
        return r.num(">f")
    if t == 0xcb:
        return r.num(">d")
    if t in _INTS:
        return r.num(_INTS[t])
    if t in _FIXEXT:
        code = r.num(">b")
        return _ext(code, r.take(_FIXEXT[t]))
    if 0xd9 <= t <= 0xdb:
        return bytes(r.take(r.num(_LEN[t - 0xd9]))).decode("utf-8")
    if t in (0xdc, 0xdd):
        return [_unpack(r) for _ in range(r.num(">H" if t == 0xdc else ">I"))]
    if t in (0xde, 0xdf):
        return _map(r, r.num(">H" if t == 0xde else ">I"))
    raise ValueError(f"msgpack: unknown type byte {t:#x}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _unpack(r)
        out[key] = _unpack(r)
    return out


def msgpack_restore(data: bytes):
    """Decode one msgpack value as flax's ``msgpack_restore`` does: nested
    dicts whose leaves are numpy arrays (read-only views of ``data``)."""
    r = _Reader(data)
    out = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("msgpack: bytes left over after the value")
    return out


def load_checkpoint(path: str):
    """Returns ``(variables_dict, batch_stats, meta)``; ``variables_dict`` has
    the ``params`` and ``batch_stats`` trees (nested dicts of numpy arrays,
    flax names) that `models.detect.Detector` takes."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return payload, payload.get("batch_stats", {}), meta
