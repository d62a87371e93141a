"""Command-line interface of the PyTorch port: the JAX package's
``cli.py`` subcommands that users run to map, serve and detect.

  replay       offline SLAM over a scan directory: writes <output>.png /
               .npy / .pcd / _trajectory.npy
  serve        HTTP control panel + background replay, and with --weights
               and --camera-dir the fused perception loop
  detect       run the detector over images (one JSON line per image)
  register     pairwise scan registration (R, t, rmse) with an overlay PNG

Every subcommand runs on the CUDA card unless ``--device cpu`` is given
(the kernels' plain PyTorch versions).  Frames and maps are read as PNG or
``.npy`` (the port has no JPEG decoder).  The detector of ``serve`` and
``detect`` is built by ``detector_from_checkpoint`` with its default, the
unfused convolutions (``F.conv2d`` + SiLU), as the JAX CLI builds it.

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
    s.add_argument("--camera-dir", default=None, help="stereo frame source (anh_1_*/anh_2_*, PNG or .npy)")
    s.add_argument("--preset", default="offline", choices=preset_names,
                   help="config preset (the reference's per-script realtime mains)")
    s.add_argument("--f32", action="store_true", help="float32 detector compute (default bfloat16)")
    device_arg(s)
    s.set_defaults(fn=cmd_serve)

    d = sub.add_parser("detect", help="run detection on images (PNG or .npy)")
    d.add_argument("images", nargs="+")
    d.add_argument("--weights", default=None, help="checkpoint (.msgpack or a v8 .pt); unfused convolutions")
    d.add_argument("--img-size", type=int, default=None,
                   help="inference resolution (default: the checkpoint's native size, else 640)")
    d.add_argument("--num-classes", type=int, default=1)
    d.add_argument("--conf", type=float, default=0.5)
    d.add_argument("--f32", action="store_true", help="float32 detector compute (default bfloat16)")
    device_arg(d)
    d.set_defaults(fn=cmd_detect)

    rg = sub.add_parser("register", help="pairwise scan registration demo")
    rg.add_argument("source", help="source scan .npy (registered onto target)")
    rg.add_argument("target", help="target scan .npy")
    rg.add_argument("--output", default=None, help="overlay PNG path")
    device_arg(rg)
    rg.set_defaults(fn=cmd_register)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
