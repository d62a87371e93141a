"""Wall time of the port's JPEG encoder against another checkout's, in one
process, in turns: what the serve cell's camera path pays for each
annotated frame it keeps for ``/camera_feed``.

    python3 scripts/torch_jpeg_encode_ab.py OTHER_ROOT [--reps N] [--readings R]

Loads ``icp_slam_yolo_tpu_torch/utils/images.py`` of the working directory
and of ``OTHER_ROOT`` (by file path: only numpy, ``zlib`` and ``struct``
are needed) and times ``encode_jpeg(frame, quality=85)`` of each on the
serve cell's camera frames (``chip_smoke.stereo_pair(300)``, 480 x 640),
alternating: ``R`` readings a side, each the mean of ``N`` calls.  Also
times this checkout's ``decode_jpeg`` of the same bytes.  Prints one line:
``this min x median y | other min x median y | ratio of medians z |
decode ...`` (ms an encode).  Runs on the host only: no card is needed.

    python3 scripts/torch_jpeg_encode_ab.py OTHER_ROOT --serve this|other

runs ``chip_smoke.py --phases serve`` (the serve cell, on the card) with
the server's encoder (``serve.state.encode_jpeg``) taken from this
checkout or from ``OTHER_ROOT`` and nothing else changed: run it in turns
to see what the encoder alone costs the triggered pairs a second.
"""

import argparse
import importlib.util
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402

IMAGES = "icp_slam_yolo_tpu_torch/utils/images.py"


def _load(root: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(root, IMAGES))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reading(call, reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="root of the checkout to compare with")
    ap.add_argument("--reps", type=int, default=10, help="calls a reading")
    ap.add_argument("--readings", type=int, default=10)
    ap.add_argument("--serve", choices=("this", "other"), help="run the serve phase with this encoder instead")
    args = ap.parse_args()
    this, other = _load(os.getcwd(), "images_this"), _load(args.other, "images_other")
    if args.serve:
        from icp_slam_yolo_tpu_torch.serve import state

        state.encode_jpeg = (this if args.serve == "this" else other).encode_jpeg
        print(f"serve phase with the {args.serve} checkout's encode_jpeg", flush=True)
        sys.exit(chip_smoke.main(["--phases", "serve"]))
    frames = chip_smoke.stereo_pair(300)
    calls = {name: (lambda m=m: [m.encode_jpeg(f, quality=85) for f in frames]) for name, m in
             (("this", this), ("other", other))}
    for call in calls.values():
        call()
    times = {name: [] for name in calls}
    for _ in range(args.readings):
        for name, call in calls.items():
            times[name].append(_reading(call, args.reps) / len(frames))
    med = {name: float(np.median(t)) for name, t in times.items()}
    data = this.encode_jpeg(frames[0], quality=85)
    dec = [_reading(lambda: this.decode_jpeg(data), 1) for _ in range(args.readings)]
    print(" | ".join(f"{name} min {min(t):.2f} median {med[name]:.2f}" for name, t in times.items())
          + f" | ratio of medians {med['this'] / med['other']:.3f} | decode of this q85 frame ({len(data)} bytes) "
          f"min {min(dec):.2f} median {float(np.median(dec)):.2f}", flush=True)


if __name__ == "__main__":
    main()
