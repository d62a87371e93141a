"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` process, all started together,
into an object file; one more ``nvcc`` links them into a shared library with
a plain C interface, loaded with ``ctypes``.  The build lands in
``icp_slam_yolo_tpu_torch/_build/<hash of sources and flags>/`` (listed in
``.gitignore``), so an unchanged checkout builds once.  Nothing here runs at
import time: the CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
SOURCES = ("nn.cu", "raster.cu", "icp.cu", "conv.cu", "c2f.cu", "knn.cu")
HEADERS = ("conv_common.cuh", "nn_common.cuh")
# -fmad=false: products and sums round as the plain PyTorch versions' separate
# operations do, so a kernel can be held to its plain version tightly
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)
# the conv kernels sum in another order than any library does, so nothing is
# gained by splitting their multiply-adds: they keep the compiler's fused ones
FUSED_MULTIPLY_ADD = ("conv.cu", "c2f.cu")
# every build reports registers, shared memory and spills (`ptxas -v`)
VERBOSE_PTXAS = ("-Xptxas", "-v")


def _flags(name: str) -> tuple:
    if name in FUSED_MULTIPLY_ADD:
        return tuple(f for f in NVCC_FLAGS if f != "-fmad=false") + VERBOSE_PTXAS
    return NVCC_FLAGS + VERBOSE_PTXAS


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "slam_nn_argmin": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "slam_raster_update": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _I,
                           _P],
    "slam_raster_update_grid": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _I, _P],
    "slam_raster_smem_bytes": [_I] * 4,
    "slam_raster_max_clusters": [_I] * 4,
    "slam_icp_fused": [_P, _P, _I, _I, _P, _P, _I, _P, _I, _F, _F, _I, _I, _I, _I] + [_P] * 8,
    "slam_icp_blocks_per_sm": [_I, _P],
    "slam_icp_clusters": [_I, _I, _P],
    "slam_conv_bias_act": [_P] * 4 + [_I] * 14 + [_P],
    "slam_c2f_smem_bytes": [_I] * 5,
    "slam_c2f_fused": [_P] * 10 + [_I] * 11 + [_P],
    "slam_knn_outlier": [_P, _P, _I, _I, _I, _F, _P, _P, _P],
}

_lib = None
build_seconds = None  # wall time of the build this process did (None: none yet)
build_logs = {}  # source -> the compiler's output of the build this process did


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use on a CUDA machine")


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(" ".join(FUSED_MULTIPLY_ADD + VERBOSE_PTXAS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build() -> str:
    """Compile the sources (in parallel) and link them; return the library path."""
    global build_seconds
    out_dir = _build_dir()
    lib_path = os.path.join(out_dir, "libslamkernels.so")
    if os.path.exists(lib_path):
        return lib_path
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for name in SOURCES:
        obj = os.path.join(out_dir, name.replace(".cu", ".o"))
        objs.append(obj)
        cmd = [nvcc, *_flags(name), "-c", os.path.join(CSRC, name), "-o", obj]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, p in procs:
        log, _ = p.communicate()
        build_logs[name] = log.decode(errors="replace")
        if p.returncode != 0:
            errors.append(f"{name}:\n{log.decode(errors='replace')}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout.decode(errors="replace"))
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0
    return lib_path


def ptxas_summary(source: str) -> list:
    """``(kernel, registers, spill bytes stored, spill bytes loaded, shared
    bytes)`` per kernel entry of a source this process built with ``ptxas
    -v`` (empty when the library came from the build cache)."""
    import re

    rows, name, spill = [], None, (0, 0)
    for line in build_logs.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill[0], spill[1], int(m.group(2) or 0)))
            name, spill = None, (0, 0)
    return rows


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for fn, argtypes in _SIGNATURES.items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        handle.slam_cuda_error_string.argtypes = [ctypes.c_int]
        handle.slam_cuda_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = lib().slam_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


_SM_COUNT = {}


def sm_count(dev) -> int:
    """SMs of the card a tensor is on (the H100's 132 for a CPU tensor, so
    the CPU tests see the plans the card gets)."""
    import torch

    if dev.type != "cuda":
        return 132
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
