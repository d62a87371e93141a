"""Train the OBB (rotated-box) detector with the PyTorch port: the
counterpart of ``scripts/train_obb.py``.

The reference's OBB recipe class (yolo11n-obb) on a polygon-labelled
dataset (each polygon -> its enclosing box and angle), the dataset held on
the card, float32 compute (the JAX script's model default).  Writes a
checkpoint (``--out``, with its JSON sidecar); like the JAX script it does
not evaluate (`models.eval.evaluate_obb_detector` does, through a
`Detector`).  The dataset is ``<data>/training``, a YOLO layout of images
and polygon labels.  Usage:

    python scripts/torch_train_obb.py --data DATASET --steps 800 --out obb_ckpt

`run(args)` is the same run for a caller (``chip_smoke.py`` phase 12).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

from torch_train_pallet import history_rows


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default="obb_hop_chu_nhat", help="dataset root with training/")
    ap.add_argument("--img-size", type=int, default=640)  # the reference used 1024
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--family", default="v8", choices=["v8", "v11", "v12"])
    ap.add_argument("--out", default="obb_ckpt")
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card (raises without one)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train and checkpoint; returns ``{"checkpoint": path, "history":
    every step's metrics}`` (read from the device at the end)."""
    from icp_slam_yolo_tpu_torch.convert import detector_params_to_numpy
    from icp_slam_yolo_tpu_torch.io.checkpoint import save_checkpoint
    from icp_slam_yolo_tpu_torch.io.yolo_data import DeviceYoloDataset
    from icp_slam_yolo_tpu_torch.models.train import create_train_state, make_train_step
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO

    ds = DeviceYoloDataset(args.data + "/training", img_size=args.img_size, batch_size=args.batch_size, max_gt=16,
                           task="obb", device=args.device)
    print(f"obb train images: {len(ds)}", flush=True)
    model = YOLO(num_classes=1, task="obb", family=args.family)
    state = create_train_state(model, args.img_size, total_steps=args.steps, device=args.device)
    step_fn = make_train_step(model, state.optimizer, args.img_size)
    it = iter(ds)
    history = []
    t0 = time.time()
    for i in range(args.steps):
        _, m = step_fn(state, next(it))
        history.append(m)
        if (i + 1) % 50 == 0 or i == 0:
            print(f"step {i + 1}/{args.steps} loss={float(m['loss']):.3f} angle={float(m.get('loss_angle', 0)):.3f} "
                  f"fg={int(m['num_fg'])} ({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
    model.eval()
    save_checkpoint(args.out, *detector_params_to_numpy(model),
                    meta={"img_size": args.img_size, "num_classes": 1, "variant": "n", "task": "obb",
                          "family": args.family, "steps": args.steps})
    print(f"checkpoint saved to {args.out}", flush=True)
    return {"checkpoint": args.out, "history": history_rows(history)}


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
