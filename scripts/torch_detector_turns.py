"""Wall time of the PyTorch port's detector forwards on one CUDA card, with
a probe of the host's own speed, for comparing checkouts in turns.

    python3 scripts/torch_detector_turns.py LABEL [--reps N] [--readings R]

Times, bfloat16, on seeded 480 x 640 frames (``chip_smoke.synthetic_frame``):
``predict_batch`` of the trained v8 checkpoint at batch 1 and 2, fused
(K5-K8) and unfused (``F.conv2d`` + ``F.silu``), and ``detect_pair`` of the
v12 checkpoint fused (the tick's detect half, host letterbox included).
Each is the mean over ``N`` calls, read ``R`` times; the line gives the
least and the median reading (the least drifts least with the host's
load).  Then times 20,000 one-element additions on the card (the host's
cost of one eager op).  Prints one line: ``LABEL v8 fused b1 min x median
y | ... | host us per add x`` (ms).  The host's speed drifts between
processes, and the probe shows by how much: run it from each checkout in
turn, alternating, in one shell on one machine.  It imports the package
and ``chip_smoke`` from the working directory, so the script of one
checkout runs another from the other's root.
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

V12 = "checkpoints/pallet_detect_v12_640.msgpack"


def _readings(call, reps: int, readings: int) -> str:
    call()
    torch.cuda.synchronize()
    out = []
    for _ in range(readings):
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / reps * 1e3)
    return f"min {min(out):.3f} median {float(np.median(out)):.3f}"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("label")
    ap.add_argument("--reps", type=int, default=20, help="calls a reading")
    ap.add_argument("--readings", type=int, default=10)
    args = ap.parse_args()
    frames = [chip_smoke.synthetic_frame(60 + i) for i in range(2)]
    parts = []
    for fused in (True, False):
        det = port.detector_from_checkpoint(chip_smoke.DETECT_CHECKPOINT, conf_threshold=1e-6, pallas_convs=fused)
        one = np.concatenate([det.preprocess(f)[0] for f in frames])
        for bsz in (1, 2):
            images = torch.from_numpy(one[:bsz]).cuda()
            parts.append(f"v8 {'fused' if fused else 'unfused'} b{bsz} "
                         + _readings(lambda: det.predict_batch(images), args.reps, args.readings))
    det = port.detector_from_checkpoint(V12, conf_threshold=1e-6, pallas_convs=True)
    parts.append("v12 detect_pair " + _readings(lambda: det.detect_pair(frames[0], frames[1]), args.reps,
                                                args.readings))
    x = torch.zeros(1, device="cuda")
    t0 = time.perf_counter()
    for _ in range(20000):
        x = x + 1.0
    torch.cuda.synchronize()
    add_us = (time.perf_counter() - t0) / 20000 * 1e6
    print(args.label, " | ".join(parts), f"| host us per add {add_us:.2f}", flush=True)


if __name__ == "__main__":
    main()
