"""What a K1 iteration costs: device time per launch of the ICP kernel on
one CUDA card with parts of each iteration switched off.

    python3 scripts/torch_icp_ablation.py

Copies ``csrc/icp.cu`` into ``icp_slam_yolo_tpu_torch/_build/ablation/``
with preprocessor switches around its parts, builds one library per switch
(all ``nvcc`` processes started together) and times each with the profiler
(``chip_smoke._device_ms``) on `chip_smoke`'s batched registrations (260
live source rows against 20000 live of 24576 target slots each) at a few
batch sizes and layouts, and against the first 256 targets.  Every run
takes 40 iterations and the final sweep (tolerance -1: the convergence test
never holds), so the variants do the same number of iterations; they
compute garbage, only their times mean anything.  Variants: ``noScan``
without the pair loop, ``noAtomic`` without the keys' atomicMin,
``noSweep`` without the whole sweep (rows, scan, merge, atomics),
``noBarrier`` without the registration's barrier, ``noMoments`` without the
key and target loads of the moments, ``noSolve`` without the solve,
``onlyLoop`` with none of sweep, moments and solve (the barrier, the block
sums and the loop); whole, but: ``regs64`` with at most 64 registers a
thread (four blocks a multiprocessor), ``group2`` / ``group8`` with
groups of 2 or 8 targets in the scan (4 in the kernel), ``noRescan``
without finding the first index again in the winning group (wrong
indices), ``wholeLanes`` with every sweep pass on 32 lanes.  Ends with the card's SM clock and power (``nvidia-smi``).
"""

import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from icp_slam_yolo_tpu_torch.ops.pallas import _lib  # noqa: E402
from icp_slam_yolo_tpu_torch.ops.pallas import icp_fused as k1  # noqa: E402

OUT = os.path.join(_lib.BUILD_ROOT, "ablation")
ITERS = 40


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"ablation: the source no longer has exactly one {old!r}")
    return src.replace(old, new)


def _guard(src: str, text: str, flag: str) -> str:
    """Wrap ``text`` in ``#ifndef flag``."""
    return _sub(src, text, f"#ifndef {flag}\n{text}#endif\n")


def common_source() -> str:
    src = open(os.path.join(_lib.CSRC, "nn_common.cuh")).read()
    return _sub(src, "    if (first[r] < 0) continue;\n",
                "#ifdef ABL_NO_RESCAN\n    if (first[r] >= 0) arg[r] = base + first[r];\n    continue;\n#endif\n"
                "    if (first[r] < 0) continue;\n")


def icp_source() -> str:
    src = open(os.path.join(_lib.CSRC, "icp.cu")).read()
    src = _sub(src, "constexpr int kGroup = 4;", "constexpr int kGroup = ABL_GROUP;")
    src = _sub(src, "    else if (rem >= 32)", "    else if (ABL_WHOLE || rem >= 32)")
    src = _sub(src, "      n = 32 * ((rem + 15) / 32);", "      n = 32 * ((rem + (ABL_WHOLE ? 31 : 15)) / 32);")
    src = _guard(src, "  nn_scan<R, kGroup>(tgt_sh, 0, m * p / P, m * (p + 1) / P, 1, px, py, best, arg);\n", "ABL_NO_SCAN")
    src = _guard(src, "    if (bd < kBig) atomicMin(keys + live[base + tid], nn_key(bd, tidx[bk]));\n", "ABL_NO_ATOMIC")
    src = _sub(src, "    if (m > 0) sweep(", "    if (ABL_SWEEP && m > 0) sweep(")
    src = _sub(src, "__launch_bounds__(kThreads) icp_kernel", "__launch_bounds__(kThreads, ABL_MIN_BLOCKS) icp_kernel")
    src = _guard(src, "    registration_barrier(cluster, count, static_cast<unsigned>(bpr), static_cast<unsigned>(it));\n",
                 "ABL_NO_BARRIER")
    src = _sub(src, "        key[h] = i < S && src_valid[i] ? __ldcg(kcur + i) : kNoKey;",
               "#ifdef ABL_NO_MOMENTS\n        key[h] = kNoKey;\n#else\n"
               "        key[h] = i < S && src_valid[i] ? __ldcg(kcur + i) : kNoKey;\n#endif\n")
    src = _sub(src, "        done_sh = solve(mo, p, solver, a.anderson != 0, a.tol);",
               "#ifdef ABL_NO_SOLVE\n        done_sh = 0;\n#else\n"
               "        done_sh = solve(mo, p, solver, a.anderson != 0, a.tol);\n#endif\n")
    defaults = {"ABL_SWEEP": 1, "ABL_MIN_BLOCKS": 1, "ABL_GROUP": 4, "ABL_WHOLE": 0}
    return "".join(f"#ifndef {k}\n#define {k} {v}\n#endif\n" for k, v in defaults.items()) + src


VARIANTS = {"base": [], "noScan": ["ABL_NO_SCAN"], "noAtomic": ["ABL_NO_ATOMIC"], "noSweep": ["ABL_SWEEP=0"],
            "noBarrier": ["ABL_NO_BARRIER"], "noMoments": ["ABL_NO_MOMENTS"], "noSolve": ["ABL_NO_SOLVE"],
            "onlyLoop": ["ABL_SWEEP=0", "ABL_NO_MOMENTS", "ABL_NO_SOLVE"], "regs64": ["ABL_MIN_BLOCKS=4"],
            "group2": ["ABL_GROUP=2"], "group8": ["ABL_GROUP=8"], "noRescan": ["ABL_NO_RESCAN"],
            "wholeLanes": ["ABL_WHOLE=1"]}
# (registrations, target slots used, row groups, slices, cluster)
CASES = [(1, 24576, 4, 33, False), (1, 256, 4, 4, False), (8, 24576, 4, 8, False), (64, 24576, 2, 8, True)]


def build() -> dict:
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "icp.cu"), "w") as f:
        f.write(icp_source())
    with open(os.path.join(OUT, "nn_common.cuh"), "w") as f:
        f.write(common_source())
    flags = [*_lib.NVCC_FLAGS, "-shared", "-I", _lib.CSRC]
    t0, procs = time.perf_counter(), {}
    for name, defs in VARIANTS.items():
        so = os.path.join(OUT, f"icp_{name}.so")
        cmd = [_lib._nvcc(), *flags, *(f"-D{d}" for d in defs), os.path.join(OUT, "icp.cu"), "-o", so]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode(errors='replace')[-4000:]}")
        f = getattr(ctypes.CDLL(so), "slam_icp_fused")
        f.argtypes, f.restype = _lib._SIGNATURES["slam_icp_fused"], ctypes.c_int
        libs[name] = f
    print(f"built {len(procs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_icp_ablation: needs a CUDA card")
    libs = build()
    dev = torch.device("cuda")
    stream = _lib.stream_ptr(dev)
    segs = cs.warehouse_segments(10000.0, 6000.0)
    n, cap, n_map, n_src = 512, 24576, 20000, 260
    for b, t, rg, sl, cl in CASES:
        maps = np.zeros((b, cap, 2), np.float32)
        srcs = np.zeros((b, n, 2), np.float32)
        for r in range(b):
            g = np.random.default_rng(100 + r % 8)
            maps[r, :n_map] = cs.map_points_along(segs, n_map, g)
            srcs[r, :n_src] = cs.map_points_along(segs, n_src, g, noise_mm=5.0) - np.array([40.0 * (r % 8) - 100, 30.0])
        src = torch.tensor(srcs, device=dev)
        sv = torch.zeros((b, n), dtype=torch.bool, device=dev)
        sv[:, :n_src] = True
        tgt = torch.tensor(maps[:, :t], device=dev).contiguous()
        tv = torch.zeros((b, t), dtype=torch.bool, device=dev)
        tv[:, : min(t, n_map)] = True
        init = torch.zeros((b, 3), device=dev)
        keys = torch.empty((k1.KEY_BUFFERS, b, n), dtype=torch.int64, device=dev)
        bar = torch.empty((b, k1.BAR_WORDS), dtype=torch.int32, device=dev)
        outs = [torch.empty(shape, dtype=dt, device=dev) for shape, dt in
                (((b, 4), torch.float32), ((b, 3), torch.float32), (b, torch.float32), (b, torch.int32),
                 (b, torch.int32))]
        times = []
        for name, f in libs.items():
            def call(f=f):
                return f(src.data_ptr(), sv.data_ptr(), b, n, tgt.data_ptr(), tv.data_ptr(), t, init.data_ptr(),
                         ITERS, 200.0 ** 2, -1.0, 0, rg, sl, int(cl), keys.data_ptr(), bar.data_ptr(),
                         *(x.data_ptr() for x in outs), stream)

            err = call()
            if err != 0:  # this variant's registers leave too few blocks resident for the layout
                times.append(f"{name} refused ({_lib.lib().slam_cuda_error_string(err).decode()})")
                continue
            ms = cs._device_ms(torch, call, 5)
            times.append(f"{name} {ms * 1e3 / (ITERS + 1):.2f}")
        print(f"B={b} {n_src} x {min(t, n_map)} of {t}, layout {rg} x {sl} {'cluster' if cl else 'grid'}, "
              f"us per iteration ({ITERS} + the final sweep): " + ", ".join(times), flush=True)
    query = "name,clocks.sm,clocks.max.sm,clocks.mem,power.draw,power.limit"
    print(subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
