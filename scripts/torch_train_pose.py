"""Train the pose detector (4 ordered pallet-corner keypoints a detection)
with the PyTorch port and report its corner quality: the counterpart of
``scripts/train_pose.py``.

The reference's labeler writes pose labels (a box and 4 corners with
visibility) for its camera frames; a pose model gives ordered tl/tr/br/bl
corners for the stereo and PnP geometry with no sorting heuristics.  The
pairs are split 80/20 with seed 42 (the reference's split convention); the
training pairs are held on the card with horizontal flips and the zoom-out
augmentation, float32 compute (the JAX script's model default).  Writes a
checkpoint (``--out``, with its JSON sidecar) and ``<out>.metrics.json``:
the validation pairs through a `Detector` built from the checkpoint (its
default: the hand-written conv kernels), `models.eval.
evaluate_pose_detector`'s metrics.  Usage:

    python scripts/torch_train_pose.py --images FRAMES --labels POSE_LABELS --steps 3000 --out pose_ckpt

`run(args)` is the same run for a caller (``chip_smoke.py`` phase 12).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import random
import time

from torch_train_pallet import history_rows


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", default="camera_data")
    ap.add_argument("--labels", default="output_pose")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--out", default="pose_ckpt")
    ap.add_argument("--eval-only", action="store_true", help="evaluate --out instead of training")
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card (raises without one)")
    return ap.parse_args(argv)


def split_pairs(images: str, labels: str) -> tuple[list, list]:
    """The (image, label) pairs, shuffled with seed 42 and split 80/20."""
    from icp_slam_yolo_tpu_torch.io.yolo_data import find_pairs

    pairs = find_pairs(images, label_root=labels)
    random.Random(42).shuffle(pairs)
    n_train = int(len(pairs) * 0.8)
    return pairs[:n_train], pairs[n_train:]


def run(args: argparse.Namespace) -> dict:
    """Train (unless ``eval_only``), checkpoint, evaluate; returns the
    validation metrics, plus ``history``: every step's metrics."""
    from icp_slam_yolo_tpu_torch.convert import detector_params_to_numpy
    from icp_slam_yolo_tpu_torch.io.checkpoint import save_checkpoint
    from icp_slam_yolo_tpu_torch.io.yolo_data import DeviceYoloDataset
    from icp_slam_yolo_tpu_torch.models.train import create_train_state, make_train_step
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO

    train_pairs, val_pairs = split_pairs(args.images, args.labels)
    print(f"pose dataset: {len(train_pairs)} train / {len(val_pairs)} val", flush=True)
    history = []
    if not args.eval_only:
        ds = DeviceYoloDataset(args.images, img_size=args.img_size, batch_size=args.batch_size, max_gt=4,
                               task="pose", augment=True, pairs=train_pairs, scale_aug=(0.5, 0.67, 0.83, 1.0),
                               device=args.device)
        model = YOLO(num_classes=1, task="pose")
        state = create_train_state(model, args.img_size, total_steps=args.steps, device=args.device)
        step_fn = make_train_step(model, state.optimizer, args.img_size)
        it = iter(ds)
        t0 = time.time()
        for i in range(args.steps):
            _, m = step_fn(state, next(it))
            history.append(m)
            if (i + 1) % 100 == 0 or i == 0:
                print(f"step {i + 1}/{args.steps} loss={float(m['loss']):.3f} kpt={float(m['loss_kpt']):.3f} "
                      f"kobj={float(m['loss_kobj']):.3f} box={float(m['loss_box']):.3f} fg={int(m['num_fg'])} "
                      f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
        model.eval()
        save_checkpoint(args.out, *detector_params_to_numpy(model),
                        meta={"img_size": args.img_size, "num_classes": 1, "variant": "n", "task": "pose",
                              "n_kpt": 4, "steps": args.steps})
        print(f"checkpoint saved to {args.out}", flush=True)

    metrics = evaluate_pose_checkpoint(args.out, val_pairs, args.img_size, device=args.device)
    print(json.dumps(metrics, indent=2), flush=True)
    with open(args.out + ".metrics.json", "w") as f:
        json.dump(metrics, f, indent=2)
    return dict(metrics, history=history_rows(history))


def evaluate_pose_checkpoint(ckpt_path: str, val_pairs, img_size: int, device=None) -> dict:
    """Corner-keypoint quality of a pose checkpoint on (image, label) pairs
    (`models.eval.evaluate_pose_detector` defines the metrics)."""
    from icp_slam_yolo_tpu_torch.io.checkpoint import load_checkpoint
    from icp_slam_yolo_tpu_torch.models.detect import Detector
    from icp_slam_yolo_tpu_torch.models.eval import evaluate_pose_detector

    payload, _, _ = load_checkpoint(ckpt_path)
    det = Detector(num_classes=1, task="pose", img_size=img_size, conf_threshold=0.25, params=payload,
                   device=device)
    metrics = evaluate_pose_detector(det, val_pairs)
    metrics["img_size"] = img_size
    return metrics


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
