"""Train the segmentation detector with the PyTorch port and report its
mask IoU: the counterpart of ``scripts/train_segment.py``.

A polygon-labelled dataset, masks rasterised from the label polygons,
bfloat16 compute with float32 parameters (``--dtype``), the dataset held on
the card.  Writes a checkpoint (``--out``, with its JSON sidecar) and
``<out>.metrics.json``: the mask IoU on ``<data>/val`` of the best
detection's mask against the first labelled polygon
(`models.eval.evaluate_segment_checkpoint`, the unfolded float32 model, as
the JAX script evaluates).  Usage:

    python scripts/torch_train_segment.py --data DATASET --steps 3000 --out seg_ckpt

`run(args)` is the same run for a caller (``chip_smoke.py`` phase 12).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

from torch_train_pallet import history_rows


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default="obb_hop_chu_nhat", help="dataset root with training/ and val/")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="forward/backward compute type; the parameters stay float32")
    ap.add_argument("--out", default="seg_ckpt")
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card (raises without one)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train, checkpoint, evaluate; returns the validation metrics, plus
    ``history``: every step's metrics (read from the device at the end)."""
    import torch

    from icp_slam_yolo_tpu_torch.convert import detector_params_to_numpy
    from icp_slam_yolo_tpu_torch.io.checkpoint import save_checkpoint
    from icp_slam_yolo_tpu_torch.io.yolo_data import DeviceYoloDataset
    from icp_slam_yolo_tpu_torch.models.eval import evaluate_segment_checkpoint
    from icp_slam_yolo_tpu_torch.models.train import create_train_state, make_train_step
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO

    ds = DeviceYoloDataset(args.data + "/training", img_size=args.img_size, batch_size=args.batch_size, max_gt=8,
                           task="segment", device=args.device)
    print(f"segment train images: {len(ds)}", flush=True)
    model = YOLO(num_classes=1, task="segment", compute_dtype=getattr(torch, args.dtype))
    state = create_train_state(model, args.img_size, total_steps=args.steps, device=args.device)
    step_fn = make_train_step(model, state.optimizer, args.img_size)
    it = iter(ds)
    history = []
    t0 = time.time()
    for i in range(args.steps):
        _, m = step_fn(state, next(it))
        history.append(m)
        if (i + 1) % 100 == 0 or i == 0:
            print(f"step {i + 1}/{args.steps} loss={float(m['loss']):.3f} mask={float(m['loss_mask']):.3f} "
                  f"fg={int(m['num_fg'])} ({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
    model.eval()
    save_checkpoint(args.out, *detector_params_to_numpy(model),
                    meta={"img_size": args.img_size, "num_classes": 1, "variant": "n", "task": "segment",
                          "steps": args.steps})
    print(f"checkpoint saved to {args.out}", flush=True)

    # the whole val split, as the JAX script evaluates it
    metrics = evaluate_segment_checkpoint(args.out, args.data + "/val", args.img_size, max_images=None,
                                          device=args.device)
    print("VAL MASK METRICS: " + json.dumps(metrics), flush=True)
    with open(args.out + ".metrics.json", "w") as f:
        json.dump(metrics, f, indent=2)
    return dict(metrics, history=history_rows(history))


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
