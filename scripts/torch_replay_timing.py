"""Wall time per step of the PyTorch port's replay on one CUDA card, with a
probe of the host's own speed.

    python3 scripts/torch_replay_timing.py LABEL [--fleet B] [--device]

Without ``--fleet``: replays 100 synthetic warehouse scans
(``chip_smoke.synthetic_sequence``) at the full-width slice configuration
three times.  With ``--fleet B``: replays ``B`` streams x 40 scans
(``chip_smoke.fleet_streams``, tiled when ``B > 8``) through
``fleet_run_sequence`` on the unchanged ``fleet`` preset three times.  Then
times 20,000 one-element additions on the card (the host's cost of one eager
op).  Prints one line: ``LABEL wall ms/step a b c | host us per add x``.
With ``--device``, then the same replay under the profiler: a second line
with the checkout's ``chip_smoke.profile_window`` report (device us and
launches a step).  To compare two checkouts, run it from each in turn,
alternating, in one shell on one machine: the host's speed drifts between
processes, and the probe shows by how much.  It imports the package and
``chip_smoke`` from the working directory, so the script of one checkout
runs another from the other's root.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402
import icp_slam_yolo_tpu_torch as port  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("label", nargs="?", default="run")
    ap.add_argument("--fleet", type=int, default=0, metavar="B", help="time fleet steps of B robots")
    ap.add_argument("--device", action="store_true", help="also profile the replay: device us and launches a step")
    args = ap.parse_args()
    if args.fleet:
        cfg = port.FLEET_CONFIG
        n = 40
        stack, _ = chip_smoke.fleet_streams(min(args.fleet, 8), n, cfg.n_max)
        stack = np.tile(stack, (-(-args.fleet // 8), 1, 1, 1))[: args.fleet]
        what = f"fleet B={args.fleet}"

        def run(scans):
            port.fleet_run_sequence(scans, cfg)

        warm = stack[:, :4]
    else:
        cfg = chip_smoke.slice_config()
        n = 100
        stack, _ = chip_smoke.padded_sequence(n, 7, cfg.n_max)
        what = "slice"

        def run(scans):
            port.Slam(cfg).run(scans)

        warm = stack[:4]
    run(warm)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(stack)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / (n - 1) * 1e3)
    x = torch.zeros(1, device="cuda")
    t0 = time.perf_counter()
    for _ in range(20000):
        x = x + 1.0
    torch.cuda.synchronize()
    add_us = (time.perf_counter() - t0) / 20000 * 1e6
    print(args.label, what, "wall ms/step", " ".join(f"{v:.3f}" for v in walls), "| host us per add", f"{add_us:.2f}")
    if args.device:
        print(args.label, what, "profiled:", chip_smoke.profile_window(torch, lambda: run(stack), n - 1), flush=True)


if __name__ == "__main__":
    main()
