"""Command-line interface of the PyTorch port: the JAX package's
``cli.py`` subcommands that users run to map, serve and detect.

  replay       offline SLAM over a scan directory: writes <output>.png /
               .npy / .pcd / _trajectory.npy
  serve        HTTP control panel + background replay, and with --weights
               and --camera-dir the fused perception loop
  detect       run the detector over images (one JSON line per image)
  register     pairwise scan registration (R, t, rmse) with an overlay PNG
  train        train the YOLO detector on a YOLO-layout dataset (float32,
               the dataset held on the device): a checkpoint + results CSV
  eval         evaluate a checkpoint on a val set (the task's metrics, JSON)
  label-check  validate YOLO label files (exit 1 on out-of-range coords
               unless --fix)
  labeler      the web labeler (polygons, paintbrush, detector assist)
  split        shuffled train/val copy of an images + labels pool
  comm-hub     the robot-side comm hub (the native link's server): prints
               inbound lines, echoes them with --echo
  comm-send    the station client: a handshake and/or one line, with the reply
  bench        benchmark: ICP registrations/s on the card against the float64
               NumPy oracle on the CPU (one JSON line); --all adds every
               BASELINE.json configuration's readings and writes
               chiprun_out/bench_detail_torch.json

Every subcommand that runs a model runs on the CUDA card unless ``--device
cpu`` is given (the kernels' plain PyTorch versions).  Frames and maps are
read as PNG, JPEG (decoded to PIL's pixels) or ``.npy``.  The detector of
``serve``, ``detect`` and ``labeler`` is built by ``detector_from_checkpoint``
with its default, the unfused convolutions (``F.conv2d`` + SiLU), as the
JAX CLI builds it, and so is the detector ``eval`` runs.

Run: ``python -m icp_slam_yolo_tpu_torch.cli <command> --help``.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def cmd_replay(args):
    import numpy as np

    from icp_slam_yolo_tpu_torch.config import PRESETS
    from icp_slam_yolo_tpu_torch.io import scans as scans_io
    from icp_slam_yolo_tpu_torch.slam.api import Slam

    cfg = PRESETS[args.preset].replace(map_capacity=args.map_capacity)
    scans, counts, paths = scans_io.load_sequence(args.scan_dir, args.start, args.end, cfg.n_max)
    print(f"loaded {len(paths)} scans from {args.scan_dir}")
    eng = Slam(cfg, device=args.device)
    t0 = time.time()
    state, outs = eng.run(scans)
    acc = outs.accepted.cpu().numpy()
    rmse = outs.rmse.cpu().numpy()
    dt = time.time() - t0
    fin = np.isfinite(rmse)
    print(
        f"replayed {len(scans)} scans in {dt:.2f}s incl. the kernels' first use ({len(scans) / dt:.1f} scans/s): "
        f"accepted {int(acc.sum())}/{len(acc)}, median rmse {float(np.median(rmse[fin])):.2f} mm, "
        f"map {len(eng.map_points())} points"
    )
    eng.save_map(args.output)
    eng.save_pcd(args.output + ".pcd")
    np.save(args.output + "_trajectory.npy", np.asarray(eng.trajectory))
    print(f"saved {args.output}.png / .npy / .pcd / _trajectory.npy")


def cmd_serve(args):
    import torch

    from icp_slam_yolo_tpu_torch.config import PRESETS
    from icp_slam_yolo_tpu_torch.serve.app import serve
    from icp_slam_yolo_tpu_torch.serve.state import ServerState

    cfg = PRESETS[args.preset].replace(map_capacity=args.map_capacity)
    state = ServerState(cfg, work_dir=args.work_dir, device=args.device)
    detector = None
    if args.weights and args.camera_dir:
        # the fused perception loop: trigger-gated stereo detect -> pallet
        # alignment on the SSE stream -> landmark fusion
        from icp_slam_yolo_tpu_torch.acquisition.camera import ReplayCamera, StereoCapture
        from icp_slam_yolo_tpu_torch.models.detect import detector_from_checkpoint

        detector = detector_from_checkpoint(
            args.weights, conf_threshold=0.5, compute_dtype=torch.float32 if args.f32 else torch.bfloat16,
            device=args.device,
        )
        stereo = StereoCapture(
            ReplayCamera(args.camera_dir, "anh_1"),
            ReplayCamera(args.camera_dir, "anh_2"),
            os.path.join(args.work_dir, "captures"),
        )
        state.attach_camera(detector, stereo)
        print(f"fused perception loop attached (weights: {args.weights})")
    print("warming up compiled paths...", flush=True)
    took = state.warmup(detector)
    print(f"warmup done in {took['total_s']:.1f} s (kernel build {took['build_s']:.1f} s)", flush=True)
    if args.scan_dir:
        state.start_replay(args.scan_dir, args.start, args.end, rate_hz=args.rate)
    serve(state, args.host, args.port)


def cmd_detect(args):
    import torch

    from icp_slam_yolo_tpu_torch.models.detect import Detector, detector_from_checkpoint
    from icp_slam_yolo_tpu_torch.utils.images import read_image

    dtype = torch.float32 if args.f32 else torch.bfloat16
    if args.weights:
        # the checkpoint's metadata selects the head, family, variant and
        # native img_size; an explicit --img-size overrides the size
        det = detector_from_checkpoint(args.weights, conf_threshold=args.conf, compute_dtype=dtype,
                                       img_size=args.img_size, device=args.device)
    else:
        det = Detector(num_classes=args.num_classes, img_size=args.img_size or 640, conf_threshold=args.conf,
                       compute_dtype=dtype, device=args.device)
    for path in args.images:
        out = det(read_image(path))
        row = {
            "image": path,
            "boxes": out["boxes"].tolist(),
            "scores": out["scores"].tolist(),
            "classes": out["classes"].tolist(),
        }
        if "angles" in out:
            row["angles"] = out["angles"].tolist()
        if "keypoints" in out:
            row["keypoints"] = out["keypoints"].tolist()
        print(json.dumps(row))


def cmd_train(args):
    from icp_slam_yolo_tpu_torch.io.yolo_data import DeviceYoloDataset
    from icp_slam_yolo_tpu_torch.models.train import fit
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO

    ds = DeviceYoloDataset(args.data, img_size=args.img_size, batch_size=args.batch_size, max_gt=args.max_gt,
                           augment=True, task=args.task, label_root=args.label_dir, device=args.device)
    steps = args.steps or (len(ds) // args.batch_size) * args.epochs
    model = YOLO(num_classes=args.num_classes, variant=args.variant, task=args.task, family=args.family)
    state, history = fit(model, iter(ds), args.img_size, steps, device=args.device)
    if args.output:
        from icp_slam_yolo_tpu_torch.convert import detector_params_to_numpy
        from icp_slam_yolo_tpu_torch.io.checkpoint import save_checkpoint
        from icp_slam_yolo_tpu_torch.models.train import write_results_csv

        save_checkpoint(args.output, *detector_params_to_numpy(state.model),
                        meta={"img_size": args.img_size, "num_classes": args.num_classes, "variant": args.variant,
                              "task": args.task, "family": args.family})
        write_results_csv(history, args.output + ".results.csv")
        print(f"saved checkpoint to {args.output}")


def cmd_eval(args):
    """Evaluate a checkpoint on a val set: the task (detect, obb, segment,
    pose) comes from its metadata, and each task reports its own metrics
    (AP, angle error, mask IoU, corner error and OKS)."""
    import sys

    from icp_slam_yolo_tpu_torch.io.checkpoint import load_checkpoint

    _, _, meta = load_checkpoint(args.weights)
    task = meta.get("task", "detect")
    img_size = args.img_size or meta.get("img_size", 640)

    if task == "segment":
        from icp_slam_yolo_tpu_torch.models.eval import evaluate_segment_checkpoint

        metrics = evaluate_segment_checkpoint(args.weights, args.data, img_size, max_images=args.max_images,
                                              device=args.device)
    else:
        from icp_slam_yolo_tpu_torch.models.detect import detector_from_checkpoint

        # AP needs the full sweep (conf 0.001); the pose metrics take the
        # best detection a frame and want a real gate
        conf = 0.25 if task == "pose" else 0.001
        det = detector_from_checkpoint(args.weights, conf_threshold=conf, img_size=args.img_size, device=args.device)
        if task == "obb":
            from icp_slam_yolo_tpu_torch.models.eval import evaluate_obb_detector

            metrics = evaluate_obb_detector(det, args.data, max_images=args.max_images)
        elif task == "pose":
            from icp_slam_yolo_tpu_torch.io.yolo_data import find_pairs
            from icp_slam_yolo_tpu_torch.models.eval import evaluate_pose_detector

            pairs = [p for p in find_pairs(args.data, label_root=args.label_dir) if os.path.exists(p[1])]
            if not pairs:
                sys.exit("eval: no labeled images found - check --data/--label-dir "
                         "(pose labels are .txt files next to the images or under --label-dir)")
            if args.val_split:
                # the pose set has no train/val directories: the 80/20 seed-42 holdout
                import random

                random.Random(42).shuffle(pairs)
                pairs = pairs[int(len(pairs) * 0.8):]
            if args.max_images:
                pairs = pairs[:args.max_images]
            metrics = evaluate_pose_detector(det, pairs)
        else:
            from icp_slam_yolo_tpu_torch.models.eval import evaluate_detector

            metrics = evaluate_detector(det, args.data, img_size, max_images=args.max_images)

    metrics = {k: (round(v, 4) if isinstance(v, float) else v) for k, v in metrics.items()}
    metrics["task"] = task
    print(json.dumps(metrics, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(metrics, f, indent=2)
        print(f"wrote {args.output}")


def cmd_register(args):
    """Pairwise scan registration: load two raw scans, gate, register,
    report (R, t, rmse) and save an overlay image."""
    import numpy as np

    from icp_slam_yolo_tpu_torch.config import OFFLINE_GATE
    from icp_slam_yolo_tpu_torch.core.registration import register
    from icp_slam_yolo_tpu_torch.io import scans as scans_io

    a = scans_io.polar_gate(scans_io.load_scan(args.target), OFFLINE_GATE)
    b = scans_io.polar_gate(scans_io.load_scan(args.source), OFFLINE_GATE)
    r, t, rmse = register(b, a, device=args.device)
    theta = float(np.arctan2(r[1, 0], r[0, 0]))
    print(json.dumps({
        "rmse_mm": round(rmse, 3),
        "theta_rad": round(theta, 6),
        "t_mm": [round(float(v), 2) for v in t],
        "source_points": len(b),
        "target_points": len(a),
    }))
    if args.output:
        from icp_slam_yolo_tpu_torch.io.render import icp_debug_view
        from icp_slam_yolo_tpu_torch.utils.images import encode_png

        aligned = scans_io.se2_apply(np.array([t[0], t[1], theta]), b)
        img = icp_debug_view(a, np.zeros((0, 2)), (0, 0, 0), size_px=800, mm_per_px=15.0)
        # overlay: target blue (already), source red, aligned green
        for pts, color in ((b, (255, 80, 80)), (aligned, (0, 255, 0))):
            px = (400 + pts[:, 0] / 15.0).astype(int)
            py = (400 - pts[:, 1] / 15.0).astype(int)
            ok = (px >= 0) & (px < 800) & (py >= 0) & (py < 800)
            img[py[ok], px[ok]] = color
        with open(args.output, "wb") as f:
            f.write(encode_png(img))
        print(f"overlay saved to {args.output}")


def cmd_comm_hub(args):
    """Run the robot-side comm hub (the ESP_AP role): print inbound command
    lines, and with ``--echo`` send each back (the handshake's partner)."""
    from icp_slam_yolo_tpu_torch.native.robotlink import RobotLinkServer

    with RobotLinkServer(args.port) as hub:
        print(f"comm hub on 127.0.0.1:{args.port} (max 2 clients); echoing handshakes", flush=True)
        try:
            while True:
                line = hub.read_command()
                if line is not None:
                    print(f"<- {line}", flush=True)
                    if args.echo:
                        hub.broadcast(line)
                time.sleep(0.01)
        except KeyboardInterrupt:
            pass


def cmd_comm_send(args):
    """Station role: connect, handshake, send one line, print the reply."""
    from icp_slam_yolo_tpu_torch.native.robotlink import RobotLinkClient

    with RobotLinkClient(args.host, args.port) as client:
        if args.handshake:
            retries = client.handshake(args.handshake)
            print(f"handshake '{args.handshake}' ok ({retries} retries)", flush=True)
        if args.message:
            client.send(args.message)
            reply = client.read_line(args.timeout_ms)
            print(f"-> {args.message}\n<- {reply}", flush=True)


def cmd_label_check(args):
    import sys

    from icp_slam_yolo_tpu_torch.data.labels import check_labels

    report = check_labels(args.directory, fix=args.fix)
    for line in report.messages:
        print(line)
    print(f"checked {report.n_files} files: {report.n_bad} with out-of-range coords"
          + (", fixed" if args.fix else ""))
    if report.n_bad and not args.fix:
        sys.exit(1)


def cmd_labeler(args):
    """Launch the web labeler (the reference's OpenCV labeling tools as a
    browser UI)."""
    from icp_slam_yolo_tpu_torch.data.labeler import LabelSession
    from icp_slam_yolo_tpu_torch.serve.labeler_app import serve_labeler

    session = LabelSession(args.image_dir, args.out_dir, classes=args.classes)
    detector = None
    if args.weights:
        from icp_slam_yolo_tpu_torch.models.detect import detector_from_checkpoint

        detector = detector_from_checkpoint(args.weights, device=args.device)
    serve_labeler(session, detector, host=args.host, port=args.port)


def cmd_split(args):
    from icp_slam_yolo_tpu_torch.data.split import split_dataset

    n_train, n_val = split_dataset(args.source, args.output, train_ratio=args.ratio, seed=args.seed)
    print(f"split {n_train + n_val} examples -> {n_train} train / {n_val} val under {args.output}")


def cmd_bench(args):
    from icp_slam_yolo_tpu_torch import bench

    bench.main(args.all, device=args.device, scan_dir=args.scan_dir)


def main(argv=None):
    from icp_slam_yolo_tpu_torch.config import PRESETS

    preset_names = sorted(PRESETS)
    p = argparse.ArgumentParser(prog="icp_slam_yolo_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    def device_arg(parser):
        parser.add_argument("--device", default=None,
                            help="torch device; default: the CUDA card (raises without one); 'cpu' runs the "
                                 "kernels' plain versions")

    r = sub.add_parser("replay", help="offline SLAM replay")
    r.add_argument("scan_dir")
    r.add_argument("--start", type=int, default=1)
    r.add_argument("--end", type=int, default=None)
    r.add_argument("--output", default="global_map_offline")
    r.add_argument("--map-capacity", type=int, default=8192)
    r.add_argument("--preset", default="offline", choices=preset_names)
    device_arg(r)
    r.set_defaults(fn=cmd_replay)

    s = sub.add_parser("serve", help="HTTP control panel")
    s.add_argument("--scan-dir", default=None)
    s.add_argument("--start", type=int, default=1)
    s.add_argument("--end", type=int, default=None)
    s.add_argument("--rate", type=float, default=10.0, help="replay rate Hz")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=5000)
    s.add_argument("--work-dir", default=".")
    s.add_argument("--map-capacity", type=int, default=8192)
    s.add_argument("--weights", default=None,
                   help="detector checkpoint for the fused loop (.msgpack or a v8 .pt); the detector runs the "
                        "unfused convolutions, detector_from_checkpoint's default")
    s.add_argument("--camera-dir", default=None, help="stereo frame source (anh_1_*/anh_2_*: JPEG, PNG or .npy)")
    s.add_argument("--preset", default="offline", choices=preset_names,
                   help="config preset (the reference's per-script realtime mains)")
    s.add_argument("--f32", action="store_true", help="float32 detector compute (default bfloat16)")
    device_arg(s)
    s.set_defaults(fn=cmd_serve)

    d = sub.add_parser("detect", help="run detection on images (JPEG, PNG or .npy)")
    d.add_argument("images", nargs="+")
    d.add_argument("--weights", default=None, help="checkpoint (.msgpack or a v8 .pt); unfused convolutions")
    d.add_argument("--img-size", type=int, default=None,
                   help="inference resolution (default: the checkpoint's native size, else 640)")
    d.add_argument("--num-classes", type=int, default=1)
    d.add_argument("--conf", type=float, default=0.5)
    d.add_argument("--f32", action="store_true", help="float32 detector compute (default bfloat16)")
    device_arg(d)
    d.set_defaults(fn=cmd_detect)

    t = sub.add_parser("train", help="train the YOLO detector")
    t.add_argument("data", help="dataset root (images/ + labels/)")
    t.add_argument("--img-size", type=int, default=640)
    t.add_argument("--batch-size", type=int, default=16)
    t.add_argument("--epochs", type=int, default=400)
    t.add_argument("--steps", type=int, default=None)
    t.add_argument("--num-classes", type=int, default=1)
    t.add_argument("--variant", default="n")
    t.add_argument("--family", default="v8", choices=["v8", "v11", "v12"],
                   help="architecture generation (v11: C3k2 + C2PSA, v12: area-attention A2C2f)")
    t.add_argument("--task", default="detect", choices=["detect", "obb", "segment", "pose"])
    t.add_argument("--max-gt", type=int, default=32)
    t.add_argument("--label-dir", default=None, help="labels in a separate directory (pose)")
    t.add_argument("--output", default=None)
    device_arg(t)
    t.set_defaults(fn=cmd_train)

    ev = sub.add_parser("eval", help="evaluate a checkpoint on a val set")
    ev.add_argument("--weights", required=True, help="checkpoint .msgpack (the task from its metadata)")
    ev.add_argument("--data", required=True, help="YOLO-layout val dir (or image dir for pose)")
    ev.add_argument("--label-dir", default=None, help="pose: a separate label directory")
    ev.add_argument("--img-size", type=int, default=None, help="override the checkpoint's native size")
    ev.add_argument("--max-images", type=int, default=None,
                    help="cap the number of val images; unset evaluates the whole directory for every task")
    ev.add_argument("--val-split", action="store_true", help="pose: evaluate the 20%% seed-42 holdout of --data")
    ev.add_argument("--output", default=None, help="write the metrics JSON here")
    device_arg(ev)
    ev.set_defaults(fn=cmd_eval)

    rg = sub.add_parser("register", help="pairwise scan registration demo")
    rg.add_argument("source", help="source scan .npy (registered onto target)")
    rg.add_argument("target", help="target scan .npy")
    rg.add_argument("--output", default=None, help="overlay PNG path")
    device_arg(rg)
    rg.set_defaults(fn=cmd_register)

    ch = sub.add_parser("comm-hub", help="run the robot comm hub (ESP_AP role)")
    ch.add_argument("--port", type=int, default=8900)
    ch.add_argument("--echo", action="store_true", help="echo lines back (handshake partner)")
    ch.set_defaults(fn=cmd_comm_hub)

    cs = sub.add_parser("comm-send", help="station client: handshake/send a line")
    cs.add_argument("--host", default="127.0.0.1")
    cs.add_argument("--port", type=int, default=8900)
    cs.add_argument("--handshake", default=None)
    cs.add_argument("--message", default=None)
    cs.add_argument("--timeout-ms", type=int, default=1000)
    cs.set_defaults(fn=cmd_comm_send)

    lc = sub.add_parser("label-check", help="validate YOLO label files")
    lc.add_argument("directory")
    lc.add_argument("--fix", action="store_true")
    lc.set_defaults(fn=cmd_label_check)

    lb = sub.add_parser("labeler", help="web labeler (polygon + paintbrush + detector assist)")
    lb.add_argument("image_dir")
    lb.add_argument("--out-dir", default="labels_out")
    lb.add_argument("--classes", nargs="+", default=["pallet"])
    lb.add_argument("--weights", default=None,
                    help="detector checkpoint for auto-label (.msgpack or a v8 .pt); unfused convolutions")
    lb.add_argument("--host", default="0.0.0.0")
    lb.add_argument("--port", type=int, default=5001)
    device_arg(lb)
    lb.set_defaults(fn=cmd_labeler)

    sp = sub.add_parser("split", help="train/val dataset split")
    sp.add_argument("source")
    sp.add_argument("output")
    sp.add_argument("--ratio", type=float, default=0.8)
    sp.add_argument("--seed", type=int, default=42)
    sp.set_defaults(fn=cmd_split)

    b = sub.add_parser("bench", help="benchmark: ICP registrations/s (one JSON line)")
    b.add_argument("--all", action="store_true",
                   help="also run the secondary benchmarks and write chiprun_out/bench_detail_torch.json")
    b.add_argument("--scan-dir", default=None,
                   help="the reference's Scan_data_1 directory (scans 350/355 are the pair); default: seeded "
                        "synthetic scans")
    device_arg(b)
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
