"""Wall time per step of the PyTorch port's replay on one CUDA card, with a
probe of the host's own speed.

    python3 scripts/torch_replay_timing.py LABEL

Replays 100 synthetic warehouse scans (``chip_smoke.synthetic_sequence``) at
the full-width slice configuration three times, then times 20,000 one-element
additions on the card (the host's cost of one eager op).  Prints one line:
``LABEL wall ms/step a b c | host us per add x``.  To compare two checkouts,
run it from each in turn, alternating, in one session on one machine: the
host's speed drifts between processes, and the probe shows by how much.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402
import icp_slam_yolo_tpu_torch as port  # noqa: E402


def main() -> None:
    label = sys.argv[1] if len(sys.argv) > 1 else "run"
    cfg = chip_smoke.slice_config()
    scans, _ = chip_smoke.synthetic_sequence(100, seed=7)
    padded = np.zeros((100, cfg.n_max, 3), np.float32)
    padded[:, : scans.shape[1]] = scans
    port.Slam(cfg).run(padded[:4])
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        port.Slam(cfg).run(padded)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / 99 * 1e3)
    x = torch.zeros(1, device="cuda")
    t0 = time.perf_counter()
    for _ in range(20000):
        x = x + 1.0
    torch.cuda.synchronize()
    add_us = (time.perf_counter() - t0) / 20000 * 1e6
    print(label, "wall ms/step", " ".join(f"{v:.3f}" for v in walls), "| host us per add", f"{add_us:.2f}")


if __name__ == "__main__":
    main()
