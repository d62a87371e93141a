"""Train the pallet detector with the PyTorch port and report its mAP: the
counterpart of ``scripts/train_pallet.py``.

The reference's detect recipe (640 px, batch 16, SGD; the JAX package's
optimizer chain), bfloat16 compute with float32 parameters, the zoom-out
augmentation and horizontal flips, the dataset held on the card.  Writes a
checkpoint (``--out``, with its JSON sidecar) and ``<out>.metrics.json``;
the evaluation runs the trained weights through ``Detector(params=...)``,
whose default is the hand-written conv kernels.  The dataset is a
YOLO-layout ``train/`` and ``val/`` of PNG images.  Usage:

    python scripts/torch_train_pallet.py --data DATASET --steps 1500 --out pallet_ckpt

`run(args)` is the same run for a caller (``chip_smoke.py`` phase 12).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default="dataset_pallet", help="dataset root with train/ and val/")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--eval-images", type=int, default=160)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate mAP50 every N steps and record the first crossing of --target-map50 "
                         "(time-to-quality)")
    ap.add_argument("--target-map50", type=float, default=0.99)
    ap.add_argument("--family", default="v8", choices=["v8", "v11", "v12"])
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="forward/backward compute type; the parameters stay float32")
    ap.add_argument("--no-scale-aug", action="store_true", help="disable the zoom-out augmentation")
    ap.add_argument("--out", default="pallet_ckpt")
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card (raises without one)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, step_hook=None) -> dict:
    """Train, checkpoint, evaluate; returns the validation metrics, plus
    ``history``: every step's metrics (read from the device at the end).
    ``step_hook(i, take_step)``, if given, is called in place of each step
    and must call ``take_step()`` once and return its metrics (a caller
    times or profiles steps through it)."""
    import torch

    from icp_slam_yolo_tpu_torch.convert import detector_params_to_numpy
    from icp_slam_yolo_tpu_torch.io.checkpoint import save_checkpoint
    from icp_slam_yolo_tpu_torch.io.yolo_data import DeviceYoloDataset
    from icp_slam_yolo_tpu_torch.models.detect import Detector
    from icp_slam_yolo_tpu_torch.models.eval import evaluate_detector
    from icp_slam_yolo_tpu_torch.models.train import create_train_state, make_train_step
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO

    scale_aug = () if args.no_scale_aug else (0.5, 0.67, 0.83, 1.0)
    ds = DeviceYoloDataset(args.data + "/train", img_size=args.img_size, batch_size=args.batch_size, max_gt=16,
                           augment=True, scale_aug=scale_aug, device=args.device)
    print(f"train images: {len(ds)} (on the device)", flush=True)
    model = YOLO(num_classes=1, family=args.family, compute_dtype=getattr(torch, args.dtype))
    state = create_train_state(model, args.img_size, total_steps=args.steps, device=args.device)
    step_fn = make_train_step(model, state.optimizer, args.img_size)
    meta = {"img_size": args.img_size, "num_classes": 1, "variant": "n", "task": "detect", "family": args.family}

    def detector():
        params, stats = detector_params_to_numpy(model)
        return Detector(num_classes=1, img_size=args.img_size, family=args.family,
                        params={"params": params, "batch_stats": stats}, device=args.device)

    it = iter(ds)
    history = []
    t0 = time.time()
    train_elapsed = 0.0
    hit_step, hit_time = None, None
    for i in range(args.steps):
        def take_step():
            return step_fn(state, next(it))[1]

        metrics = step_hook(i, take_step) if step_hook is not None else take_step()
        history.append(metrics)
        if (i + 1) % 50 == 0 or i == 0:
            print(f"step {i + 1}/{args.steps} loss={float(metrics['loss']):.3f} box={float(metrics['loss_box']):.3f} "
                  f"cls={float(metrics['loss_cls']):.3f} dfl={float(metrics['loss_dfl']):.3f} "
                  f"fg={int(metrics['num_fg'])} ({(train_elapsed + time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
        if (i + 1) % 250 == 0:
            save_checkpoint(args.out, *detector_params_to_numpy(model), meta=dict(meta, steps=i + 1))
        # time-to-quality: the evaluation's wall time is left out of the crossing time
        if args.eval_every and (i + 1) % args.eval_every == 0 and hit_step is None:
            train_elapsed += time.time() - t0
            m = evaluate_detector(detector(), args.data + "/val", args.img_size, max_images=args.eval_images)
            print(f"eval @ step {i + 1}: mAP50={m['mAP50']:.4f} (train wall {train_elapsed:.0f}s)", flush=True)
            if m["mAP50"] >= args.target_map50:
                hit_step, hit_time = i + 1, train_elapsed
            t0 = time.time()

    if args.eval_every:
        train_elapsed += time.time() - t0
    model.eval()
    save_checkpoint(args.out, *detector_params_to_numpy(model), meta=dict(meta, steps=args.steps))
    print(f"checkpoint saved to {args.out}", flush=True)

    m = evaluate_detector(detector(), args.data + "/val", args.img_size, max_images=args.eval_images)
    if args.eval_every:
        m["time_to_map50_target_s"] = round(hit_time, 1) if hit_step else None
        m["steps_to_map50_target"] = hit_step
        m["map50_target"] = args.target_map50
    print("VAL METRICS: " + json.dumps(m), flush=True)
    with open(args.out + ".metrics.json", "w") as f:
        json.dump(m, f, indent=2)
    return dict(m, history=history_rows(history))


def history_rows(history: list) -> list:
    """Each step's metrics (dicts of device tensors) as plain floats, read
    from the device in one transfer."""
    import torch

    if not history:
        return []
    keys = list(history[0])
    table = torch.stack([torch.stack([h[k].float() for k in keys]) for h in history]).cpu().tolist()
    return [dict(zip(keys, row)) for row in table]


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
