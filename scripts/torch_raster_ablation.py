"""What a K2 or K4 call costs: device time per launch of the raster kernel
on one CUDA card, at each layout `raster_plan` can take (512 or 1024
threads a block), with parts of the kernel switched off.

    python3 scripts/torch_raster_ablation.py [variant ...]

Copies ``csrc/raster.cu`` into ``icp_slam_yolo_tpu_torch/_build/ablation/``
with preprocessor switches around its parts, builds one library per switch
(all ``nvcc`` processes started together) and times each with the profiler
(``chip_smoke._device_ms``) at the paths' shapes: K2 on the slice's 833 x
1000 grid (one robot), K4 on the fleet's 864 x 1024 grids at B = 1, 8 and
64; 512 rays a robot, 90 % live, endpoints within the 140 px window, a
grid of mostly free cells with 1 % occupied.  Variants that switch a part
off compute garbage; only their times mean anything: ``noWalk`` without
the walk that finds where each ray stops (no ray stops), ``noLookup``
without the walk's blocked-cell lookups, ``noCount`` without the counts,
``noApply`` without the update of the window, ``noRx`` without the
received column counts in the update, ``noCopy`` without K2's copy of the
cells outside the window; whole, but ``walk3`` with 3
chunks of a walk's lookups in flight (5 in the kernel), ``noPow`` without
the powf calls that fill the decay^n table (a constant in their place),
``compact`` with the 512-thread blocks' compact shared-memory layout at
1024 threads too (no staged rows: the old values come from device memory;
Tx leaves after all the counting), and ``timeline``
(``compactTimeline`` with the compact layout), which records the SM clock at each phase's end in every block of the
robots' clusters (a block barrier at each mark) and prints each phase's
mean and largest time over those blocks, in ns.  The copies between the
blocks are never switched off: a receiver would wait for them forever.
Ends with the card's SM clock and power (``nvidia-smi``).  Variants named
on the command line are built and timed in that order; none: all of them.
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
import icp_slam_yolo_tpu_torch as port  # noqa: E402
from icp_slam_yolo_tpu_torch.ops.pallas import _lib  # noqa: E402
from icp_slam_yolo_tpu_torch.ops.pallas import raster_fused as rf  # noqa: E402
from icp_slam_yolo_tpu_torch.ops.raster import window_dims  # noqa: E402

OUT = os.path.join(_lib.BUILD_ROOT, "ablation")


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"ablation: the source no longer has exactly one {old!r}")
    return src.replace(old, new)


TIMELINE = """
#ifdef ABL_TIMELINE
__device__ long long abl_clock[4096][10];
#define ABL_MARK(k) do { __syncthreads(); if (threadIdx.x == 0 && blockIdx.x < 4096) abl_clock[blockIdx.x][k] = clock64(); } while (0)
extern "C" int abl_read(void* dst) { return static_cast<int>(cudaMemcpyFromSymbol(dst, abl_clock, sizeof(abl_clock))); }
#else
#define ABL_MARK(k)
#endif
"""
# the marks of the timeline variant: (text, mark before it or after it, mark index)
MARKS = (
    ("  // the barriers\n", "after", 0),
    ("      // a warp walks each ray to its first blocked body sample, and tells every rank\n", "before", 1),
    ("      // while the stops come: zeroed tables; each ray's geometry (kThreads >= kRayGroup)\n", "before", 2),
    ("      // every stop of the group here; every walker's lookups, done before it\n", "before", 3),
    ("      // the counts of each of the rank's samples before its ray's stop, the\n", "before", 4),
    ("    // the decay^n table while Tx is on its way", "before", 5),
    ("    mbar_wait(bar_tx, band & 1);\n", "after", 6),
    ("    cluster_meet();  // every bulk copy out of this block has landed\n", "before", 7),
    ("    cluster_meet();  // every bulk copy out of this block has landed\n", "after", 8),
)
PHASES = ("barriers", "walk", "tables, geometry", "stops received", "counted, Tx sent", "table, Tx received, rows staged",
          "update", "last barrier")


def raster_source() -> str:
    src = open(os.path.join(_lib.CSRC, "raster.cu")).read()
    src = _sub(src, "constexpr int kWalk = 5;", "constexpr int kWalk = ABL_WALK_CHUNKS;")
    src = _sub(src, "        for (int base = 0; base <= ray.last && s == kNone;",
               "      for (int base = 0; ABL_WALK && base <= ray.last && s == kNone;")
    src = _sub(src, "            p[u] = __ldg(", "            p[u] = !ABL_LOOKUP ? 0.0f : __ldg(")
    src = _sub(src, "      if (ly >= y0 && ly < y1 && lx >= 0 && lx < a.side_x) {\n        // Ty",
               "      if (ABL_COUNT && ly >= y0 && ly < y1 && lx >= 0 && lx < a.side_x) {\n        // Ty")
    src = _sub(src, "    // the update of this rank's rows",
               "    if (!ABL_APPLY) {\n      cluster_meet();\n      return;\n    }\n    // the update of this rank's rows")
    src = _sub(src, "tyr[32 * u] + rxr[(32 * u) >> kLog2];", "tyr[32 * u] + (ABL_RX ? rxr[(32 * u) >> kLog2] : 0u);")
    src = _sub(src, "    const int blk = blockIdx.x - a.B * C;\n", "    const int blk = blockIdx.x - a.B * C;\n    if (!ABL_COPY) return;\n")
    src = _sub(src, "pow_s[n] = powf(a.decay, static_cast<float>(n));", "pow_s[n] = ABL_POW ? powf(a.decay, static_cast<float>(n)) : 0.5f;")
    src = _sub(src, "  constexpr bool kCompact = kThreads < 1024;", "  constexpr bool kCompact = ABL_COMPACT || kThreads < 1024;")
    src = _sub(src, "kThreads < 1024).total)", "ABL_COMPACT || kThreads < 1024).total)")
    src = _sub(src, '#include "nn_common.cuh"\n', '#include "nn_common.cuh"\n' + TIMELINE)
    for text, where, k in MARKS:
        src = _sub(src, text, text + f"  ABL_MARK({k});\n" if where == "after" else f"  ABL_MARK({k});\n" + text)
    defaults = {"ABL_WALK_CHUNKS": 5, "ABL_WALK": 1, "ABL_LOOKUP": 1, "ABL_COUNT": 1,
                "ABL_APPLY": 1, "ABL_RX": 1, "ABL_COPY": 1, "ABL_POW": 1, "ABL_COMPACT": 0}
    return "".join(f"#ifndef {k}\n#define {k} {v}\n#endif\n" for k, v in defaults.items()) + src


VARIANTS = {"base": [], "noWalk": ["ABL_WALK=0"], "noLookup": ["ABL_LOOKUP=0"], "noCount": ["ABL_COUNT=0"],
            "noApply": ["ABL_APPLY=0"], "noRx": ["ABL_RX=0"], "noCopy": ["ABL_COPY=0"], "walk3": ["ABL_WALK_CHUNKS=3"], "noPow": ["ABL_POW=0"], "timeline": ["ABL_TIMELINE"],
            "compact": ["ABL_COMPACT=1"], "compactTimeline": ["ABL_COMPACT=1", "ABL_TIMELINE"]}
# (kernel, preset, robots)
CASES = [("K2", port.OFFLINE_CONFIG, 1), ("K4", port.FLEET_CONFIG, 1), ("K4", port.FLEET_CONFIG, 8),
         ("K4", port.FLEET_CONFIG, 64)]


def build(names) -> dict:
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "raster.cu"), "w") as f:
        f.write(raster_source())
    flags = [*_lib.NVCC_FLAGS, "-shared", "-I", _lib.CSRC]
    t0, procs = time.perf_counter(), {}
    for name in names:
        defs = VARIANTS[name]
        so = os.path.join(OUT, f"raster_{name}.so")
        cmd = [_lib._nvcc(), *flags, *(f"-D{d}" for d in defs), os.path.join(OUT, "raster.cu"), "-o", so]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode(errors='replace')[-4000:]}")
        lib = ctypes.CDLL(so)
        for entry in ("slam_raster_update", "slam_raster_update_grid"):
            getattr(lib, entry).argtypes, getattr(lib, entry).restype = _lib._SIGNATURES[entry], ctypes.c_int
        if "ABL_TIMELINE" in VARIANTS[name]:
            lib.abl_read.argtypes, lib.abl_read.restype = [ctypes.c_void_p], ctypes.c_int
        libs[name] = lib
    print(f"built {len(procs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


def inputs(cfg, b: int, rng):
    """``b`` robots at random cells of ``cfg``'s grid, 512 rays each."""
    dev = torch.device("cuda")
    h, w, n, win = cfg.map.height_px, cfg.map.width_px, cfg.n_max, cfg.occupancy.window_px
    side_y, side_x = window_dims(h, w, cfg.occupancy)
    occ = np.where(rng.random((b, h, w)) < 0.01, 0.9, rng.uniform(0.2, 0.6, (b, h, w))).astype(np.float32)
    meta, eys, exs = [], [], []
    for _ in range(b):
        ry, rx = int(rng.integers(0, h)), int(rng.integers(0, w))
        y0, x0 = min(max(ry - win, 0), h - side_y), min(max(rx - win, 0), w - side_x)
        meta.append([y0, x0, ry - y0, rx - x0])
        eys.append(rng.integers(max(ry - win, 0), min(ry + win, h), n) - y0)
        exs.append(rng.integers(max(rx - win, 0), min(rx + win, w), n) - x0)
    t = {"occ": torch.tensor(occ, device=dev), "meta": torch.tensor(meta, dtype=torch.int32, device=dev),
         "ey": torch.tensor(np.array(eys), dtype=torch.int32, device=dev),
         "ex": torch.tensor(np.array(exs), dtype=torch.int32, device=dev),
         "live": torch.tensor(rng.random((b, n)) < 0.9, device=dev),
         "accept": torch.ones(b, dtype=torch.bool, device=dev)}
    return t, side_y, side_x


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_raster_ablation: needs a CUDA card")
    names = sys.argv[1:] or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"torch_raster_ablation: unknown variants {sorted(unknown)}; known: {list(VARIANTS)}")
    libs = build(names)
    dev = torch.device("cuda")
    stream = _lib.stream_ptr(dev)
    rng = np.random.default_rng(0)
    clock_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                     capture_output=True, text=True).stdout.split()[0])
    for kernel, cfg, b in CASES:
        t, side_y, side_x = inputs(cfg, b, rng)
        occ = t["occ"]
        out = torch.empty_like(occ)
        _, h, w = occ.shape
        n = t["ey"].shape[1]
        occ_cfg = cfg.occupancy
        common = (t["meta"].data_ptr(), t["ey"].data_ptr(), t["ex"].data_ptr(), t["live"].data_ptr(),
                  t["accept"].data_ptr(), None, n, side_y, side_x, occ_cfg.max_ray_px, occ_cfg.block_threshold,
                  occ_cfg.p_free_decay, occ_cfg.p_occ_inc)  # the presets' windows: one band, no stops kept
        for threads in (512, 1024):
            try:
                plan = rf.raster_plan(b, h, w, side_y, side_x, n, occ_cfg.max_ray_px, in_place=kernel == "K4",
                                      threads=threads, sm=_lib.sm_count(dev))
            except ValueError:
                continue
            times, timeline = [], ""
            for name, lib in libs.items():
                if kernel == "K2":
                    def call(lib=lib):
                        return lib.slam_raster_update(occ.data_ptr(), out.data_ptr(), b, h, w, *common,
                                                      plan.threads, plan.bands, plan.copy_clusters, plan.copy_vec,
                                                      stream)
                else:
                    def call(lib=lib):
                        return lib.slam_raster_update_grid(occ.data_ptr(), b, h, w, *common,
                                                           plan.threads, plan.bands, stream)
                err = call()
                if err != 0:
                    times.append(f"{name} refused ({_lib.lib().slam_cuda_error_string(err).decode()})")
                    continue
                times.append(f"{name} {cs._device_ms(torch, call, 20) * 1e3:.2f}")
                if "ABL_TIMELINE" in VARIANTS[name]:
                    call()
                    torch.cuda.synchronize()
                    marks = np.zeros((4096, 10), np.int64)
                    lib.abl_read(marks.ctypes.data_as(ctypes.c_void_p))
                    d = np.diff(marks[: b * rf.CLUSTER, : len(MARKS)], axis=1) / (clock_mhz * 1e-3)
                    timeline += f"; {name}: " + "; ".join(f"{p} {m:.2f}/{x:.2f}" for p, m, x in zip(PHASES, d.mean(0), d.max(0)))
            print(f"{kernel} B={b} {h}x{w}, cluster {rf.CLUSTER} x {plan.threads} threads"
                  f"{f', {plan.copy_clusters} copy clusters' if kernel == 'K2' else ''}, us per launch: "
                  + ", ".join(times) + f"; timeline of the robots' blocks, us mean/max{timeline or ': not measured'}", flush=True)
    query = "name,clocks.sm,clocks.max.sm,clocks.mem,power.draw,power.limit"
    print(subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
