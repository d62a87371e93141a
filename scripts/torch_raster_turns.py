"""Device time per launch of K2 and K4 (``raster_update``,
``raster_update_grid``) on one CUDA card at the presets' windows, for
comparing two checkouts in turns.

    python3 scripts/torch_raster_turns.py LABEL [--reps N]

Times, with ``chip_smoke._one_launch_ms`` (one kernel event a call,
required): K2 on the ``offline`` preset's 833 x 1000 grid (one robot), K4
on the ``fleet`` preset's 864 x 1024 grids at B = 8 with 1024 and with 512
threads a block, and at B = 64 in the plan's layout; 512 rays a robot, 90 %
live, endpoints within the 140 px window, seeded.  Prints one line:
``LABEL K2 x | K4 B=8 1024 x | K4 B=8 512 x | K4 B=64 x`` (us, each the
mean over ``N`` calls, three readings each).  It imports the package and
``chip_smoke`` from the working directory and calls only the wrappers'
keyword interface, which the one-band and the banded kernels share, so the
script of one checkout runs another from the other's root: run parent,
change, change, parent in one shell.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402
import icp_slam_yolo_tpu_torch as port  # noqa: E402
from icp_slam_yolo_tpu_torch.ops.pallas.raster_fused import raster_update, raster_update_grid  # noqa: E402
from icp_slam_yolo_tpu_torch.ops.raster import window_dims  # noqa: E402


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
    args = (torch.tensor(occ, device=dev), torch.tensor(meta, dtype=torch.int32, device=dev),
            torch.tensor(np.array(eys), dtype=torch.int32, device=dev),
            torch.tensor(np.array(exs), dtype=torch.int32, device=dev),
            torch.tensor(rng.random((b, n)) < 0.9, device=dev), torch.ones(b, dtype=torch.bool, device=dev))
    o = cfg.occupancy
    kw = dict(side_y=side_y, side_x=side_x, k=o.max_ray_px, p_occ_inc=o.p_occ_inc, p_free_decay=o.p_free_decay,
              block_threshold=o.block_threshold)
    return args, kw


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("label")
    ap.add_argument("--reps", type=int, default=200, help="calls a reading")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_raster_turns: needs a CUDA card")
    rng = np.random.default_rng(0)
    (occ1, *rest1), kw1 = inputs(port.OFFLINE_CONFIG, 1, rng)
    (occ8, *rest8), kw8 = inputs(port.FLEET_CONFIG, 8, rng)
    (occ64, *rest64), kw64 = inputs(port.FLEET_CONFIG, 64, rng)
    torch.cuda.synchronize()
    cases = {"K2": lambda: raster_update(occ1, *rest1, **kw1),
             "K4 B=8 1024": lambda: raster_update_grid(occ8, *rest8, **kw8, threads=1024),
             "K4 B=8 512": lambda: raster_update_grid(occ8, *rest8, **kw8, threads=512),
             "K4 B=64": lambda: raster_update_grid(occ64, *rest64, **kw64)}
    parts = []
    for name, call in cases.items():
        call()
        us = [chip_smoke._one_launch_ms(torch, call, opts.reps, name) * 1e3 for _ in range(3)]
        parts.append(f"{name} " + " ".join(f"{v:.3f}" for v in us))
    print(opts.label, " | ".join(parts), flush=True)


if __name__ == "__main__":
    main()
