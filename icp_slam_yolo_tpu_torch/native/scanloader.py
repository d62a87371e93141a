"""ctypes binding for the native batched scan loader (with a Python
fallback); the counterpart of the JAX package's ``native/scanloader.py``.
Host I/O only: the batch comes back as numpy."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from icp_slam_yolo_tpu_torch.native.build import build_library, library_available

_lib = None


def _load():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build_library("scanloader"))
        _lib.sl_load_batch.restype = ctypes.c_int
        _lib.sl_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
    return _lib


def load_batch_native(paths: list[str], n_max: int, n_threads: int | None = None):
    """Load + pad a list of scan files into ``(T, n_max, 3)`` float32 via C++.

    Per-file failures (missing/odd format) leave zero rows and count -1 —
    matching the Python loader's skip semantics.  Falls back to the Python
    loader when no toolchain is available.
    """
    if not library_available():
        from icp_slam_yolo_tpu_torch.io import scans as scans_io

        out = np.zeros((len(paths), n_max, 3), np.float32)
        counts = np.full(len(paths), -1, np.int32)
        for i, p in enumerate(paths):
            try:
                raw = scans_io.load_scan(p)
                out[i] = scans_io.pad_scan(raw, n_max)
                counts[i] = len(raw)
            except Exception:
                pass
        return out, counts

    lib = _load()
    t = len(paths)
    out = np.zeros((t, n_max, 3), np.float32)
    counts = np.zeros(t, np.int32)
    c_paths = (ctypes.c_char_p * t)(*[p.encode() for p in paths])
    threads = n_threads or min(8, os.cpu_count() or 1)
    lib.sl_load_batch(
        c_paths, t, n_max,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads,
    )
    return out, counts
