"""On-demand ``g++`` build of the native libraries, cached by modification
time in the port's own build directory."""

from __future__ import annotations

import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build", "native")

_SOURCES = {
    "robotlink": "robotlink.cpp",
    "scanloader": "scanloader.cpp",
}


def library_available() -> bool:
    return shutil.which("g++") is not None


def build_library(name: str) -> str:
    """Compile ``name`` if its library is missing or older than its source;
    return the shared object's path."""
    src = os.path.join(_SRC_DIR, _SOURCES[name])
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    if not library_available():
        raise RuntimeError("g++ not available to build native library")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"  # a concurrent build never loads a half-written file
    subprocess.run(
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", src, "-o", tmp, "-lpthread"],
        check=True,
        capture_output=True,
    )
    os.replace(tmp, out)
    return out
