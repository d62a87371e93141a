"""Read and write the repo's model checkpoints: one msgpack file (as flax's
serialization writes it) with a JSON sidecar ``<path>.json``.

The port imports neither flax nor a msgpack package, so it codes the format
itself: the msgpack types a checkpoint uses (maps, arrays, strings, binary,
integers, floats, booleans, nil) and flax's extension types: 1 is an ndarray,
packed as ``(shape, dtype name, bytes)``; 2 a complex number ``(re, im)``; 3
a numpy scalar, packed like an ndarray.  The writer emits what a checkpoint
holds: maps with string keys, ndarrays and numpy scalars (extension types
1 and 3), and inside those the shape's integers, the dtype's name and the
bytes, each in the shortest form msgpack has for it, as the msgpack
package does.
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


# ---------------------------------------------------------------- writing

def _head(out: list, n: int, fix: int, fix_max: int, codes: tuple) -> None:
    """A length header: the fix form (``fix | n``) up to ``fix_max``, else
    the 8-, 16- or 32-bit form (``codes``, None where the type has none)."""
    if n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: a length of {n} does not fit")


def _pack_int(out: list, v: int) -> None:
    if 0 <= v <= 0x7f or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
    elif v >= 0:
        code, fmt = next((c, f) for c, f, lim in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff), (0xce, ">I", 0xffffffff),
                                                  (0xcf, ">Q", 2**64 - 1)) if v <= lim)
        out.append(bytes([code]) + struct.pack(fmt, v))
    else:
        code, fmt = next((c, f) for c, f, lim in ((0xd0, ">b", 2**7), (0xd1, ">h", 2**15), (0xd2, ">i", 2**31),
                                                  (0xd3, ">q", 2**63)) if v >= -lim)
        out.append(bytes([code]) + struct.pack(fmt, v))


def _pack(out: list, v) -> None:
    if isinstance(v, dict):
        _head(out, len(v), 0x80, 0x0f, (None, 0xde, 0xdf))
        for key, sub in v.items():
            if not isinstance(key, str):
                raise TypeError(f"msgpack: checkpoint keys are strings, got {key!r}")
            _pack(out, key)
            _pack(out, sub)
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 0x0f, (None, 0xdc, 0xdd))
        for sub in v:
            _pack(out, sub)
    elif isinstance(v, str):
        data = v.encode("utf-8")
        _head(out, len(data), 0xa0, 0x1f, (0xd9, 0xda, 0xdb))
        out.append(data)
    elif isinstance(v, bytes):
        _head(out, len(v), 0, -1, (0xc4, 0xc5, 0xc6))
        out.append(v)
    elif isinstance(v, (np.ndarray, np.generic)):  # extension 1, a numpy scalar 3
        arr = np.asarray(v)  # (ascontiguousarray would make a 0-d array 1-d)
        body: list = []
        _pack(body, (list(arr.shape), arr.dtype.name, arr.tobytes("C")))
        data = b"".join(body)
        code = 1 if isinstance(v, np.ndarray) else 3
        if len(data) in (1, 2, 4, 8, 16):
            out.append(bytes([{1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}[len(data)], code]))
        else:
            _head(out, len(data), 0, -1, (0xc7, 0xc8, 0xc9))
            out.append(bytes([code]))
        out.append(data)
    elif isinstance(v, int) and not isinstance(v, bool):
        _pack_int(out, v)
    else:
        raise TypeError(f"msgpack: cannot pack {type(v).__name__}")


def msgpack_serialize(tree) -> bytes:
    """Encode nested dicts (string keys) of numpy arrays as flax's
    ``to_bytes`` does, to the same bytes: keys in the dicts' order, each
    array an extension of type 1 holding the msgpack of ``(shape, dtype
    name, C-order bytes)``."""
    out: list = []
    _pack(out, tree)
    return b"".join(out)


def save_checkpoint(path: str, params, batch_stats=None, meta: dict | None = None) -> None:
    """Write ``{"params": params, "batch_stats": batch_stats}`` (flax trees
    of numpy arrays, e.g. `convert.detector_params_to_numpy`'s) to ``path``
    and ``meta`` to ``<path>.json``: what flax's ``msgpack_restore`` and
    `load_checkpoint` read back."""
    data = msgpack_serialize({"params": params, "batch_stats": batch_stats or {}})
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    with open(path + ".json", "w") as f:
        json.dump(meta or {}, f, indent=2)
