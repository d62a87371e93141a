"""What bounds the port's conv kernels (K5-K8): device time per launch on
one CUDA card with parts of each kernel switched off.

    python3 scripts/torch_conv_ablation.py

Copies ``csrc/conv.cu`` and ``csrc/c2f.cu`` into
``icp_slam_yolo_tpu_torch/_build/ablation/`` with preprocessor switches
around their parts, builds one library per switch (all ``nvcc`` processes
started together) and times each at a few yolo-n sites in bfloat16 with the
profiler (``chip_smoke._device_ms``).  The variants compute garbage; only
their times mean anything.  conv (the ``mma.sync`` tile at the site's plan):
``noA`` / ``noW`` without the A or the W copies, ``noAW`` without both,
``noMMA`` without the products, ``noChunks`` with no chunk at all (the
fixed cost: row tables, epilogue, launch), ``noChunksStore`` that without
the epilogue's stores, ``noSync`` without the barrier per chunk.  C2f: ``onlyN`` runs product N alone, ``none`` none of them,
``noRemote`` without the stores into the cluster's other blocks, ``noW`` /
``noMMA`` / ``noX`` without the weight copies, the products or the staging
of x.  Ends with the card's SM clock and power under a stream of K6
launches (``nvidia-smi``).
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

OUT = os.path.join(_lib.BUILD_ROOT, "ablation")


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"ablation: the source no longer has exactly one {old!r}")
    return src.replace(old, new)


def _guard(src: str, begin: str, end: str, flag: str) -> str:
    """Wrap the text from ``begin`` to ``end`` (both included) in ``#ifndef flag``."""
    return _sub(_sub(src, begin, f"#ifndef {flag}\n{begin}"), end, f"{end}#endif\n")


def conv_source() -> str:
    src = open(os.path.join(_lib.CSRC, "conv.cu")).read()
    src = _guard(src, "#pragma unroll\n    for (int m = tid / SEGS;",
                 "cp_async16(smem_addr(As + m * TT::AROW + seg * 8), src, ok ? 16 : 0);\n    }\n", "ABL_NO_A")
    src = _guard(src, "#pragma unroll\n    for (int i = tid; i < BK * BN / 8; i += kConvThreads) {",
                 "cp_async16(smem_addr(Bs + kr * TT::BROW + sg * 8), ok ? w + (size_t)kw * Cout + n : w, ok ? 16 : 0);\n"
                 "    }\n", "ABL_NO_W")
    src = _guard(src, "      warp_k16<TT::MT, TT::NP>(acc, a, TT::MT, b);\n",
                 "      warp_k16<TT::MT, TT::NP>(acc, a, TT::MT, b);\n", "ABL_NO_MMA")
    src = _guard(src, "    store_rows<BM, BN>(ring, OROW, out, M, Cout, m0, n0, tid, kConvThreads);\n",
                 "    store_rows<BM, BN>(ring, OROW, out, M, Cout, m0, n0, tid, kConvThreads);\n", "ABL_NO_STORE")
    src = _sub(src, "  const int n_local = gb((rank + 1) * per) - c_begin;",
               "#ifdef ABL_NO_CHUNKS\n  const int n_local = 0;\n#else\n"
               "  const int n_local = gb((rank + 1) * per) - c_begin;\n#endif")
    return _guard(src, "    __syncthreads();  // chunk i has landed for every thread;",
                  " stage (i - 1) % kStages is free\n", "ABL_NO_SYNC")


def c2f_source() -> str:
    src = open(os.path.join(_lib.CSRC, "c2f.cu")).read()
    src = _guard(src, "#pragma unroll\n      for (int j = 0; j < (W_COPIES",
                 "ok ? wm.w + (size_t)k * wm.ld + n : wm.w, ok ? 16 : 0);\n        }\n      }\n", "ABL_NO_W")
    src = _guard(src, "        warp_k16<TT::MT, 1>(acc, a, mt_count, b);\n",
                 "        warp_k16<TT::MT, 1>(acc, a, mt_count, b);\n", "ABL_NO_MMA")
    src = _guard(src, "      cp_async16(smem_addr(dst + row * kARow + seg * 8),",
                 "ok ? x + (size_t)gp * Cin + k : x, ok ? 16 : 0);\n", "ABL_NO_X")
    for bit, call in ((1, "product<WBN, kBK, VEC>(smem, L, L.P1,"),
                      (2, "product<BN, VEC ? kBKVec : kBK, VEC>(smem, L, L.P2,"),
                      (4, "product<BN, VEC ? kBKVec : kBK, VEC>(smem, L, L.P3,"),
                      (8, "product<WBN, VEC ? kBKVec : kBK, VEC>(smem, L, L.P3,")):
        src = _sub(src, f"    {call}", f"    if (ABL_STAGES & {bit}) {call}")
    src = _guard(src, "  for (int q = 1; q < S; ++q) st_cluster(", "(rank + q) & (S - 1)), bits);\n", "ABL_NO_REMOTE")
    return "#ifndef ABL_STAGES\n#define ABL_STAGES 15\n#endif\n" + src


CONV_VARIANTS = {"base": [], "noA": ["ABL_NO_A"], "noW": ["ABL_NO_W"], "noAW": ["ABL_NO_A", "ABL_NO_W"],
                 "noMMA": ["ABL_NO_MMA"], "noChunks": ["ABL_NO_CHUNKS"],
                 "noChunksStore": ["ABL_NO_CHUNKS", "ABL_NO_STORE"], "noSync": ["ABL_NO_SYNC"]}
C2F_VARIANTS = {"base": [], "only1": ["ABL_STAGES=1"], "only2": ["ABL_STAGES=2"], "only3": ["ABL_STAGES=4"],
                "only4": ["ABL_STAGES=8"], "none": ["ABL_STAGES=0"], "noRemote": ["ABL_NO_REMOTE"],
                "noW": ["ABL_NO_W"], "noMMA": ["ABL_NO_MMA"], "noX": ["ABL_NO_X"]}
# (k, stride, Cin, Cout, H = W of the input, batch, tile rows, tile columns, split): sites of a 640 px forward
CONV_SITES = [(3, 1, 64, 64, 80, 2, 64, 64, 1), (3, 1, 32, 32, 80, 2, 64, 32, 1), (3, 1, 128, 64, 40, 2, 64, 64, 4),
              (3, 1, 256, 64, 20, 2, 32, 64, 8), (3, 1, 64, 64, 80, 8, 128, 64, 1), (1, 1, 64, 64, 80, 2, 32, 64, 1)]
# (Cin, c, F, H = W, batch, tile, cluster)
C2F_SITES = [(256, 128, 256, 20, 2, 8, 4), (256, 128, 256, 20, 2, 4, 4), (384, 64, 128, 40, 2, 8, 2),
             (32, 16, 32, 160, 2, 8, 1), (192, 32, 64, 80, 2, 8, 1), (256, 128, 256, 20, 8, 8, 1)]


def build() -> dict:
    os.makedirs(OUT, exist_ok=True)
    for kind, src in (("conv", conv_source()), ("c2f", c2f_source())):
        with open(os.path.join(OUT, f"{kind}.cu"), "w") as f:
            f.write(src)
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             "-I", _lib.CSRC]
    t0, procs = time.perf_counter(), {}
    for kind, variants in (("conv", CONV_VARIANTS), ("c2f", C2F_VARIANTS)):
        for name, defs in variants.items():
            so = os.path.join(OUT, f"{kind}_{name}.so")
            cmd = [_lib._nvcc(), *flags, *(f"-D{d}" for d in defs), os.path.join(OUT, f"{kind}.cu"), "-o", so]
            procs[(kind, name)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for key, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log.decode(errors='replace')[-4000:]}")
        fn = "slam_conv_bias_act" if key[0] == "conv" else "slam_c2f_fused"
        f = getattr(ctypes.CDLL(so), fn)
        f.argtypes, f.restype = _lib._SIGNATURES[fn], ctypes.c_int
        libs[key] = f
    print(f"built {len(procs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_conv_ablation: needs a CUDA card")
    libs = build()
    rng = np.random.default_rng(0)
    stream = _lib.stream_ptr(torch.device("cuda"))
    for k, stride, cin, cout, h, bsz, bm, bn, split in CONV_SITES:
        x, w, b = cs._conv_case(torch, rng, torch.bfloat16, bsz, h, h, cin, cout, k)
        out = torch.empty(bsz, h // stride, h // stride, cout, dtype=torch.bfloat16, device="cuda")
        times = []
        for name in CONV_VARIANTS:
            f = libs[("conv", name)]

            def call(f=f):
                return f(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, h, h, cin, cout, k, stride,
                         1, 1, 1, bm, bn, split, 0, stream)

            if call() != 0:
                raise RuntimeError(f"conv {name}: launch failed")
            times.append(f"{name} {cs._device_ms(torch, call, 20) * 1e3:.2f}")
        print(f"conv {k}x{k}/{stride} {cin}->{cout} @{h} B={bsz} tile {bm} x {bn} split {split}, us: "
              + ", ".join(times), flush=True)
    for cin, c, feat, h, bsz, tile, cluster in C2F_SITES:
        args = cs._c2f_case(torch, rng, torch.bfloat16, bsz, h, h, cin, c, feat)
        out = torch.empty(bsz, h, h, feat, dtype=torch.bfloat16, device="cuda")
        times = []
        for name in C2F_VARIANTS:
            f = libs[("c2f", name)]

            def call(f=f):
                return f(*[a.data_ptr() for a in args], out.data_ptr(), bsz, h, h, cin, c, feat, tile, cluster, 1, 1,
                         1, stream)

            if call() != 0:
                raise RuntimeError(f"c2f {name}: launch failed")
            times.append(f"{name} {cs._device_ms(torch, call, 20) * 1e3:.2f}")
        print(f"c2f Cin {cin} c {c} F {feat} @{h} B={bsz} tile {tile} cluster {cluster}, us: " + ", ".join(times),
              flush=True)
    # the SM clock while the card runs a stream of K6 launches
    k6 = libs[("conv", "base")]
    x, w, b = cs._conv_case(torch, rng, torch.bfloat16, 2, 80, 80, 64, 64, 3)
    out = torch.empty(2, 80, 80, 64, dtype=torch.bfloat16, device="cuda")
    for _ in range(30000):
        k6(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), 2, 80, 80, 64, 64, 3, 1, 1, 1, 1, 64, 64, 1, 0,
           stream)
    query = "name,clocks.sm,clocks.max.sm,clocks.mem,power.draw,power.limit"
    print(subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
