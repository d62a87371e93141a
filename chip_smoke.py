"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints a line; any failed check raises, so the script exits
non-zero; they run in the order 1-3, 7-13, 4-6, 14, 15, 16, 17, see `main`):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels (``nvcc``, first use) and print the build time
     and each kernel's registers, shared memory and spills (``ptxas -v``);
  3. hold each kernel (K1 ICP, K2 raster, K3 nearest neighbour, K4 fleet
     raster) against its plain PyTorch version on the card, at the shapes the
     paths below give it, one robot and batched (B = 8, B = 64), and time
     both (device time from the profiler) and, for K3, the library call
     ``torch.cdist(...).min``; K1 at B = 1, 8 and 64 with its time a sweep
     and a sweep's fixed cost (the same registrations against 256 targets),
     and every other K1 layout that fits forced and required to give the
     picked layout's bits; K3 at 512 x 512, B = 8, B = 64 and the rescue's
     512 x 24576 (targets duplicated T/2 apart, so ties straddle the
     cluster's slices), every layout forced, each required bit-equal; K2
     and K4 each one device launch a call (one kernel event a call in their
     profiles), both layouts `raster_plan` can take (512 or 1024 threads a
     block) forced and
     required to give the same bits, K2's bound printed for its window alone
     and with the new grid it writes; then again at small edge cases (ragged
     sizes, nothing valid, a window clamped at the grid's corner, K2 and K4
     on a small window in both layouts and with 1100 rays a robot); then K2
     (one robot, its window clamped at the grid's corner) and K4 (8 robots)
     on a 640 x 640 window with rays of up to 620 samples, which they take
     in three bands of rows, in both layouts, each the plain version's bits
     and one kernel event a call, timed beside the presets' window; then K9
     (the statistical outlier filter, one launch) at the fleet's 512 slots at
     B = 1, 8 and 256 with edge rows (none valid, one, ten, every point
     twice, stray returns) against its plain version (mean k-NN distance
     within 1e-2 mm, masks equal but within 0.05 mm of the threshold), k
     beyond its 32 refused, timed beside its bound, the plain version and the filter before it (``bmm`` +
     ``torch.topk``), and on the fleet path one launch a step, no top-k and
     no ``(B, N, N)`` tensor (``--phases knn`` runs 1-2 and this alone);
  (every profiler window of phases 4-6 holds the raster kernels' event
  counts equal to the wrappers' launch counts in the window;)
  4. the ``slice`` path: ``Slam(cfg).run(scans)`` at the full-width offline
     configuration without the GICP rescue over a seeded synthetic
     warehouse, with launch counters reset just before and read just after;
     five steps under PyTorch's sync debug mode (no host synchronisation);
     then the first scans again on ``device="cpu"`` (plain versions) and a
     comparison of poses and accept flags;
  5. the fleet path: ``fleet_run_sequence`` on the unchanged ``fleet`` preset,
     8 distinct streams x 100 scans and 64 streams x 30 scans, with launch
     counters (one launch per kernel per fleet step), quality checks per
     robot, five fleet steps under the sync debug mode, a profiler window,
     robot 0 against the single-robot ``Slam``, and a CPU fleet replay;
  6. the presets: ``Slam(OFFLINE_CONFIG)`` and ``Slam(REALTIME_CONFIG)``
     unchanged on sequences with garbage scans, which force the GICP rescue
     and, under ``realtime``, the reseed, and a profiler window over each
     preset's steps on the good scans; ``gicp()`` on the card against the CPU;
  7. the detector's kernels (K5 1x1, K6 3x3, K7 3x3 stride 2 conv + bias +
     SiLU, K8 the whole C2f block) against their plain versions on the card,
     in bfloat16 and float32, at every distinct shape of a yolo-n forward at
     640 px and of a YOLO12-L forward at 1024 px (`YOLO12L_SITES`: Cin up to
     1280, the ABlocks' 307-channel MLP and their ``qkv`` and ``proj`` 1x1s
     without SiLU) at batch 1, 2 and 8 plus edge cases, with device times (kernel,
     plain version, and the library's ``F.conv2d`` + ``F.silu``); in
     bfloat16 also the variants the wrappers do not pick, forced (the other
     gather, the split or cluster on and off, every K8 tile and cluster that
     fits), and two launches at one site giving the same bits; then every
     K5-K7 launch of the v11 and v12 checkpoints' forwards (batch 1, 2, 8;
     bfloat16 and float32) held against its plain version on its input;
  8. the detector path: ``detector_from_checkpoint`` on the trained v8 detect
     weights, bfloat16, 640 px, fused: ``__call__``, ``detect_pair`` and
     ``predict_batch`` at batch 8 on seeded synthetic frames, with launch
     counters (7 / 6 / 12 / 20 launches of K7 / K8 / K5 / K6 per forward);
     fused against unfused head outputs; float32 on the card against the
     port on the CPU; a segment checkpoint through the fused path; then the
     v12 detect and v11 obb checkpoints the same way (82 / 32 / 7 and 44 /
     37 / 7 launches of K5 / K6 / K7 a forward, K8 none), each run between
     a reset and a reading of the counters; then YOLO12-L at 1024 px on
     seeded weights through ``predict_batch`` (128 / 54 / 7 launches of K5 /
     K6 / K7 a forward, K8 none; each launch held against its plain version;
     float32 head outputs against `reference_impl/yolo12.py`);
  9. detector times: per forward at batch 1, 2, 8 and 32, fused and unfused,
     for the v8, v12 and v11 checkpoints;
  10. the fused SLAM + detect tick (`tick`; ``BASELINE.json`` configuration
     4): ``SlamConfig(map_capacity=8192)``, the v12 detector in bfloat16,
     seeded scans and stereo pairs, 61 ticks with launch counters (K1, K2,
     K3, K5, K6, K7 each launched), the SLAM quality checks, ticks/s, a
     profiler window over the tick and over each half alone, and 8 float32
     ticks on the card against the same ticks on the CPU;
  11. the entry points users run (`serve_path`): the server
     (``ServerState`` + the HTTP layer) on ``OFFLINE_CONFIG`` with 8192 map
     slots and the v12 detector in bfloat16 on the fused path behind a
     replayed PNG stereo camera: its warm-up (K1-K3 and K5-K7 launched, its
     time beside phase 2's build), 120 seeded ``.npy`` scans replayed
     unthrottled and driven over HTTP (a POI and its target fire the camera;
     ``camera_data`` on the stream; the map PNG equal to the engine's
     occupancy, a tile, the ICP view, a camera JPEG and an MJPEG part; the
     map saved, loaded back and the last 10 scans tracked in reverse in
     localization), the
     server held to a direct ``Slam.run`` of the same scans, a profiler
     window over served scans; ``cli replay`` and ``cli detect`` in
     subprocesses against the direct run and an in-process detector; a v8
     ``.pt`` (K5-K8) against the msgpack detector;
  12. training (`train_path`): a seeded synthetic YOLO dataset of PNG
     frames (`pallet_dataset`); one float32 train step at 64 px, card
     against CPU (v8 detect, v11 obb); the pallet recipe
     (`scripts/torch_train_pallet.run`: yolo-n v8, 640 px, batch 16,
     bfloat16 compute, the dataset on the card) for 60 timed steps with a
     profiler window, the loss required to fall, then 10 float32 steps; the
     trained checkpoint through the fused detector (K5-K8 launches a
     forward, every launch held against its plain version, fused against
     unfused, mAP on ``val/``); v12 detect, v11 obb, v8 segment and pose
     steps at 640 px, bfloat16, with device augmentation; the task scripts
     (`scripts/torch_train_{obb,segment,pose}.run`, 3 steps each), each
     checkpoint evaluated through the fused detector with every K5-K8
     launch held against its plain version; ``cli train`` and ``cli eval``
     in subprocesses;
  13. JPEG decoding and the labeling toolchain (`label_path`): the committed
     JPEG fixtures decoded and held to the digests of PIL's pixels, decode
     times of 480 x 640 frames; 8 seeded pallet frames written as JPEG,
     labeled over HTTP (``serve_labeler``'s routes in process, ``POST
     /label/auto`` through the trained v8 detector, fused, bfloat16, 640 px:
     12 / 20 / 7 / 6 launches of K5 / K6 / K7 / K8 a frame, then
     ``/label/save``), ``cli label-check`` and ``cli split`` on the result,
     the split's ``val/`` evaluated through the same detector, a segment
     auto-label; ``cli detect`` on a JPEG; every auto-label launch held
     against its plain version; float32 auto-label polygons, card against
     CPU;
  14. the shared-map fleet (`shared_path`): ``shared_fleet_run`` on the
     ``fleet`` preset unchanged, 8 robots leaving one depot x 100 scans and
     64 (the 8 tiled 8 times) x 20 scans, every robot building one map: K1,
     K3 and K4 launches a step counted, every robot's trajectory checked,
     five steps under the sync debug mode, a profiler window over each run,
     the first 8 steps on the CPU against the card, and a 2-robot
     interleave of one stream against the single-robot ``Slam``;
  15. several processes on ``torch.distributed`` (`dist_path`): (a) one
     rank, NCCL, in this process: ``fleet_run_sharded`` (8 x 100) and the
     shared map (R = 8 x 100) over the group, each bit-equal to its
     one-card run, with K1, K3 and K4 launches a step counted; five fleet
     and five shared steps over the group under the sync debug mode; a
     profiler window over each, the NCCL kernels listed apart; the pallet
     recipe's data-parallel step (yolo-n v8, 640 px, batch 16, bf16) for
     20 steps against the step without a mesh on the same batches; (b) two
     spawned ranks sharing the card over gloo: the shared map (R = 8, 4 a
     rank, x 20), the fleet (8 x 30) and two data-parallel steps of 2 x 8
     against 1 x 16, the replicated map and grid bit-identical across the
     ranks at every step; then a line saying NCCL across cards was not run;
  16. `cli bench`, the registration benchmark (`bench_path`): the entry point
     in a subprocess (headline only, the root ``bench.py``'s keys on its last
     line); K1 at the bench pair's shapes (B = 64, 50 iterations) against
     its plain version; then ``bench.run`` with every reading (what ``cli
     bench --all`` calls: the headline, the single pair, the SLAM loop on
     three configurations, the detector at batch 8 and 128, the fleet and
     its matched single stream, the fused tick, the train step) with launch
     counters: every key present and finite, every reading within its
     bound, the bench's own checks passed, K1-K8 each launched;
  17. one JSON line listing the kernels (each kernel's launches summed over
     the paths of phases 4-6, 8, 10, 11, 12, 13, 14, 15 and 16), then the card
     line, then the result line ``{"ok": true, "device": {...}}`` last.

The synthetic scan generator (`synthetic_sequence`) lives in
``icp_slam_yolo_tpu_torch/io/synthetic.py``; this script imports it, so the
CPU tests can take it from here.
"""

from __future__ import annotations

import dataclasses
import json
import re
import struct
import subprocess
import sys
import time

import numpy as np

# the synthetic warehouse (`io/synthetic.py`); the CPU tests take these names from here
from icp_slam_yolo_tpu_torch.io.synthetic import synthetic_sequence, warehouse_segments

# ---------------------------------------------------------------- synthetic data


def relative_poses(poses: np.ndarray) -> np.ndarray:
    """Ground truth in the first scan's frame: ``T_0^-1 T_k``."""
    x0, y0, t0 = poses[0]
    c, s = np.cos(t0), np.sin(t0)
    dx, dy = poses[:, 0] - x0, poses[:, 1] - y0
    th = np.arctan2(np.sin(poses[:, 2] - t0), np.cos(poses[:, 2] - t0))
    return np.stack([c * dx + s * dy, -s * dx + c * dy, th], axis=1)


def map_points_along(segs: np.ndarray, n: int, rng, noise_mm: float = 10.0) -> np.ndarray:
    """``n`` noisy points spread over the walls by length."""
    lengths = np.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1])
    which = rng.choice(len(segs), size=n, p=lengths / lengths.sum())
    u = rng.random(n)
    pts = segs[which, :2] + u[:, None] * (segs[which, 2:] - segs[which, :2])
    return pts + rng.normal(0.0, noise_mm, (n, 2))


# ---------------------------------------------------------------- measurement

PEAK_FP32 = 67e12   # FP32 operations/s outside the tensor cores (H100 SXM data sheet)
PEAK_BF16 = 989e12  # dense bfloat16 operations/s in the tensor cores (H100 SXM data sheet)
PEAK_BYTES = 3.35e12  # HBM bytes/s (H100 SXM data sheet)


def _bound(ops: float, nbytes: float, peak_ops: float = PEAK_FP32):
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_events(torch, prof) -> list:
    """The profiler's per-name averages of device-side events (kernels,
    memcpys, memsets); host operators are left out so nothing counts twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0 and "spin_kernel" not in e.key]


def _traced(torch, fn):
    """Run ``fn`` under ``torch.profiler`` and return the profile.  The
    tracer may miss device work of the first milliseconds after it is
    switched on and of the last before it is switched off, so ``fn`` runs
    between two idle spins of the card (`_kernel_events` leaves them out).
    The port's stage span records are dropped after it."""
    from torch.profiler import ProfilerActivity, profile

    from icp_slam_yolo_tpu_torch.utils.profiling import clear_spans

    def spin():
        torch.cuda._sleep(20_000_000)  # ~10 ms of a kernel that does nothing
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        spin()
        fn()
        torch.cuda.synchronize()
        spin()
    clear_spans()  # the stage spans recorded: nothing here reads them
    return prof


def _device_profile(torch, fn, reps: int) -> dict:
    """Device time per call by event name (ms): the kernels' own times that
    ``torch.profiler`` records over ``reps`` calls.  Raises if it records
    none, so a time always means device time.  Each name's time is its mean
    over the records the tracer kept, times its launches per call, so a
    lost record (reported on a line of its own) does not lower the time."""
    def calls():
        for _ in range(reps):
            fn()

    fn()
    torch.cuda.synchronize()
    events = _kernel_events(torch, _traced(torch, calls))
    for _ in range(4):  # on a busy host a trace now and then keeps nothing: measure again
        if events:
            break
        print("    (profiler: a trace recorded no device time; measuring again)", flush=True)
        events = _kernel_events(torch, _traced(torch, calls))
    if not events:
        raise RuntimeError("the profiler recorded no device time in five traces")
    lost = {e.key[:40]: e.count for e in events if e.count % reps}
    if lost:
        print(f"    (profiler: records lost, counts over {reps} calls: {lost})", flush=True)
    return {e.key: e.self_device_time_total / e.count * -(-e.count // reps) / 1e3 for e in events}


def _one_launch_ms(torch, fn, reps: int, what: str) -> float:
    """Device time per call (ms) of a raster wrapper, which must be one device
    launch: the profile of ``reps`` calls holds the raster kernel's events
    and nothing else (no fill, no second pass), one a call.  The tracer was
    seen to drop one record of every trace for the rest of a run once it
    starts doing so; a trace short of ``reps`` is then held against a trace
    of ``2 reps`` calls, whose count must be larger by exactly ``reps`` (one
    launch a call, whatever the tracer drops), and the time is the mean
    over the records kept.  Otherwise the trace is taken once more."""
    def trace(n):
        def calls():
            for _ in range(n):
                fn()

        events = _kernel_events(torch, _traced(torch, calls))
        return events, {e.key[:60]: e.count for e in events}

    def raster_only(events):
        return len(events) == 1 and "raster_kernel" in events[0].key

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        events, counts = trace(reps)
        if raster_only(events) and events[0].count == reps:
            return events[0].self_device_time_total / reps / 1e3
        if raster_only(events) and events[0].count < reps:
            more, counts2 = trace(2 * reps)
            if raster_only(more) and more[0].key == events[0].key and more[0].count - events[0].count == reps:
                print(f"    (profiler: {what}: {events[0].count} events over {reps} calls, {more[0].count} over "
                      f"{2 * reps}: records lost, one launch a call)", flush=True)
                return events[0].self_device_time_total / events[0].count / 1e3
            counts = f"{counts}, over {2 * reps} calls {counts2}"
        print(f"    (profiler: {what}: events over {reps} calls {counts}; measuring again)", flush=True)
    raise AssertionError(f"{what}: not one device launch a call: events over {reps} calls {counts}")


# Layouts checked beside each kernel's pick, each required to give the
# reference's bits (`_held_layout`); phases 3 (K1-K4) and 7 (K5-K8) print
# the counts and require `LAYOUTS_AT_LEAST`, so a change that drops layouts
# from a kernel's `layouts` shows
LAYOUTS_CHECKED = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8"), 0)
LAYOUTS_AT_LEAST = {"K1": 15, "K2": 16, "K3": 32, "K4": 16, "K5": 534, "K6": 200, "K7": 161, "K8": 255}


def _held_layout(kernel: str, same: bool, what: str) -> None:
    _require(same, what)
    LAYOUTS_CHECKED[kernel] += 1


def layouts_checked(kernels: tuple) -> None:
    """Print and require the layouts each of ``kernels`` checked."""
    counts = {k: LAYOUTS_CHECKED[k] for k in kernels}
    print(f"[layouts] checked beside the picks, each the same bits: {counts} (at least "
          f"{ {k: LAYOUTS_AT_LEAST[k] for k in kernels} })", flush=True)
    _require(all(counts[k] >= LAYOUTS_AT_LEAST[k] for k in kernels), f"too few layouts checked: {counts}")


def raster_plans(plan_args: tuple, in_place: bool = False) -> dict:
    """`raster_fused.layouts` at these shapes on the card, by threads a block."""
    import torch

    from icp_slam_yolo_tpu_torch.ops.pallas import _lib, raster_fused as rf

    return {p.threads: p for p in rf.layouts(*plan_args, in_place=in_place, sm=_lib.sm_count(torch.device("cuda")))}


def raster_layouts(what: str, call, timed, reference, plan_args: tuple, reps: int, in_place: bool = False) -> str:
    """Every layout of `raster_fused.layouts` at these shapes: ``call(plan)``
    must give ``reference``'s bits; ``timed(plan)``, one launch, gives the
    device us of each.  Also holds each layout's shared memory to the
    kernel's own count."""
    import torch

    from icp_slam_yolo_tpu_torch.ops.pallas import _lib

    times = []
    for t, plan in raster_plans(plan_args, in_place).items():
        side_y, side_x = plan_args[3], plan_args[4]
        _require(_lib.lib().slam_raster_smem_bytes(side_y, side_x, t, plan.bands) == plan.smem_bytes,
                 f"{what}: raster_plan's shared memory differs from the kernel's at {t} threads")
        _held_layout("K4" if in_place else "K2", torch.equal(call(plan), reference),
                     f"{what}: {t} threads differ from the picked layout")
        times.append(f"{t} threads ({plan.smem_bytes} bytes of shared memory) "
                     f"{_one_launch_ms(torch, lambda: timed(plan), reps, what) * 1e3:.2f} us")
    _require(len(times) > 0, f"{what}: no layout fits")
    return "; ".join(times)


def _device_ms(torch, fn, reps: int) -> float:
    """Device time per call (ms), summed over the call's device events."""
    return sum(_device_profile(torch, fn, reps).values())


def _kernel_name(mangled: str) -> str:
    """``conv_bf16_kernel<128, 64, 0>`` from a mangled kernel name (the tail
    of the mangled name where it does not parse)."""
    m = re.search(r"\d+([A-Za-z][A-Za-z0-9_]*?_kernel)I(.*?)EE", mangled)
    if not m:
        return mangled[-60:]
    args = [num or {"f": "float", "d": "double"}[t] for num, t in re.findall(r"L[ib](\d+)E|([fd])", m.group(2) + "E")]
    return f"{m.group(1)}<{', '.join(args)}>"


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def padded_sequence(n_scans: int, seed: int, n_max: int, **kw):
    """`synthetic_sequence` padded to ``n_max`` rows: ``(scans (n, n_max, 3),
    ground truth (n, 3))``."""
    scans, gt = synthetic_sequence(n_scans, seed=seed, **kw)
    padded = np.zeros((n_scans, n_max, 3), np.float32)
    padded[:, : scans.shape[1]] = scans
    return padded, gt


def garbage_like(scans: np.ndarray, seed: int) -> np.ndarray:
    """The same beams with ranges drawn at random: scans no pose explains."""
    rng = np.random.default_rng(seed)
    out = scans.copy()
    out[..., 2] = np.where(out[..., 2] > 0, rng.uniform(1200.0, 8000.0, out[..., 2].shape), 0.0)
    return out.astype(np.float32)


def trajectory_errors(poses: np.ndarray, gt: np.ndarray):
    """Position (mm) and heading (rad) error of ``poses (T-1, 3)`` against
    ground truth ``gt (T, 3)`` taken in the first scan's frame, and the
    distance travelled up to each scan."""
    rel = relative_poses(gt)[1:]
    pos_err = np.hypot(poses[:, 0] - rel[:, 0], poses[:, 1] - rel[:, 1])
    ang_err = np.abs(np.arctan2(np.sin(poses[:, 2] - rel[:, 2]), np.cos(poses[:, 2] - rel[:, 2])))
    travelled = np.concatenate([[0.0], np.cumsum(np.hypot(*np.diff(gt[:, :2], axis=0).T))])[1:]
    return pos_err, ang_err, travelled


def check_quality(what: str, cfg, acc, rmse, poses, gt, state, forced_rejects=None):
    """The quality checks of a replay: finite poses; acceptance (outside
    ``forced_rejects``, a mask of scans built to be rejected); median inlier
    RMSE under the gate; position error below 2 % of the distance travelled
    + 150 mm at every scan (scan-to-map odometry drifts with distance) and
    heading error < 0.05 rad; a map count in range and a painted grid within
    [0, 1] (``state`` of one robot)."""
    free = np.ones_like(acc) if forced_rejects is None else ~forced_rejects
    pos_err, ang_err, travelled = trajectory_errors(poses, gt)
    _require(np.isfinite(poses).all(), f"{what}: non-finite poses")
    _require(acc[free].mean() >= 0.95, f"{what}: acceptance {acc[free].mean()}")
    _require(np.median(rmse[acc]) < cfg.icp.max_rmse, f"{what}: median rmse above the gate")
    _require(bool((pos_err < 0.02 * travelled + 150.0).all()) and ang_err.max() < 0.05,
             f"{what}: trajectory drifted from ground truth (max {pos_err.max():.1f} mm, {ang_err.max():.4f} rad)")
    n_map_pts = int(state.map_valid.sum())
    _require(0 < n_map_pts <= cfg.map_capacity, f"{what}: map count out of range")
    occ_np = state.occ.cpu().numpy()
    _require(occ_np.min() >= 0.0 and occ_np.max() <= 1.0 and (occ_np != 0.5).sum() > 1000,
             f"{what}: occupancy grid not painted or out of [0, 1]")
    return pos_err, ang_err


RASTER_KERNELS = ("raster_update", "raster_update_grid")


def profile_window(torch, fn, n_steps: int, apart: str | None = None) -> str:
    """Run ``fn`` (``n_steps`` steps ending in a synchronise) under the
    profiler and describe where the device time went (`window_summary`);
    the kernels whose names hold ``apart`` are also listed on their own."""
    from icp_slam_yolo_tpu_torch.ops import pallas

    before = dict(pallas.LAUNCHES)
    wall = []

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    prof = _traced(torch, timed)
    summary = window_summary(torch, prof, wall[0], n_steps, before)
    if apart is None:
        return summary
    own = [e for e in _kernel_events(torch, prof) if apart in e.key.lower()]
    listed = "; ".join(f"{e.key[:60]} {e.self_device_time_total / n_steps:.1f} ({e.count} events)" for e in own)
    return (f"{summary}; {apart} kernels (included above) "
            f"{sum(e.self_device_time_total for e in own) / n_steps:.1f} us/step: {listed or 'none'}")


def window_summary(torch, prof, wall: float, n_steps: int, before: dict) -> str:
    """Where the device time of a profiled window of ``n_steps`` steps
    (``wall`` seconds) went: busy share, device us and launches a step, the
    top kernels.  The raster kernels' device events must number the
    wrappers' launches in the window since ``before`` (one device launch a
    call), so a lost profiler record shows."""
    from icp_slam_yolo_tpu_torch.ops import pallas

    avgs = sorted(_kernel_events(torch, prof), key=lambda e: -e.self_device_time_total)
    raster_launches = sum(pallas.LAUNCHES[k] - before[k] for k in RASTER_KERNELS)
    raster_events = sum(e.count for e in avgs if "raster_kernel" in e.key)
    _require(raster_events == raster_launches,
             f"profile window: {raster_events} raster kernel events for {raster_launches} raster launches")
    dev_us = sum(e.self_device_time_total for e in avgs)
    top = "; ".join(f"{e.key[:48]} {e.self_device_time_total / n_steps:.1f}" for e in avgs[:6])
    n_launch = sum(e.count for e in avgs)
    # what the sums would be if no record was lost: each name's mean over the
    # records kept, times its launches per step rounded up (equal to the
    # sums when every count is a multiple of the steps)
    whole = sum(e.self_device_time_total / e.count * -(-e.count // n_steps) for e in avgs)
    short = sum(1 for e in avgs if e.count % n_steps)
    return (f"raster events {raster_events} = raster launches {raster_launches}; "
            f"device busy {dev_us / 1e6 / wall:.3f} of wall (profiler on), wall {wall / n_steps * 1e3:.2f} ms/step, "
            f"device {dev_us / n_steps:.1f} us/step, {n_launch / n_steps:.0f} device launches/step "
            f"({short} of {len(avgs)} kernel names with a count that is no multiple of the steps; with every name's "
            f"launches per step rounded up: {whole:.1f} us/step); top kernels us/step: {top}")


def slice_config():
    """The slice's configuration: the CLI's default ``offline`` preset at full
    width, without the GICP second chance (a later slice)."""
    import icp_slam_yolo_tpu_torch as port

    return port.OFFLINE_CONFIG.replace(icp=dataclasses.replace(port.OFFLINE_CONFIG.icp, rescue_estimator=""))


def k1_registration(cfg, n_map: int, rng) -> tuple:
    """One K1 registration (B = 1) at ``cfg``'s shapes: the first synthetic
    scan, gated and downsampled into ``cfg.n_max`` source slots, against
    ``n_map`` points along the warehouse's walls in ``cfg.map_capacity``
    target slots, started 100 / -80 mm and 0.03 rad off the true pose.
    Returns (the kernel's five inputs, its options, the true pose)."""
    import torch

    from icp_slam_yolo_tpu_torch.ops import geometry as geo
    from icp_slam_yolo_tpu_torch.ops.voxel import voxel_downsample

    dev = torch.device("cuda")
    cap, n = cfg.map_capacity, cfg.n_max
    map_np = np.zeros((cap, 2), np.float32)
    map_np[:n_map] = map_points_along(warehouse_segments(10000.0, 6000.0), n_map, rng)
    map_valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    map_valid[:n_map] = True
    map_xy = torch.tensor(map_np, device=dev)
    scans1, gt1 = synthetic_sequence(1, seed=1)
    scan1 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    scan1[: scans1.shape[1]] = torch.tensor(scans1[0], device=dev)
    xy, valid = geo.polar_to_cartesian(scan1, cfg.gate)
    ds_xy, ds_valid = voxel_downsample(xy, valid, cfg.icp.voxel_size_mm)
    truth = torch.tensor(gt1[0], dtype=torch.float32, device=dev)
    init = truth + torch.tensor([100.0, -80.0, 0.03], device=dev)
    kw = dict(iters=cfg.icp.max_iterations, threshold_mm=cfg.icp.threshold_mm, tolerance=cfg.icp.tolerance)
    one = tuple(x[None].contiguous() for x in (ds_xy, ds_valid, map_xy, map_valid, init))
    return one, kw, truth


def k1_against_plain(what: str, one: tuple, kw: dict) -> tuple:
    """``icp_fused`` against ``icp_fused_plain`` on the same registrations:
    poses within 1 mm / 2e-3 rad, rmse within 1 mm, iterations within 5.
    Returns (the kernel's four outputs, (mm, rad, rmse mm, the plain
    version's most iterations), the plain version as a function)."""
    import torch

    from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import _finish, _prepare, icp_fused, icp_fused_plain

    got = icp_fused(*one, **kw)
    params, tgt_c, c = _prepare(*one[2:])
    plain_fn = lambda: icp_fused_plain(one[0], one[1], tgt_c, one[3], params, iters=kw["iters"],  # noqa: E731
                                       thr2=kw["threshold_mm"] ** 2, tolerance=kw["tolerance"], anderson=False)
    pose_p, rmse_p, _, it_p = _finish(plain_fn(), c)
    torch.cuda.synchronize()
    pose_k, rmse_k, _, it_k = got
    dpos = float((pose_k[:, :2] - pose_p[:, :2]).abs().max())
    dang = float((pose_k[:, 2] - pose_p[:, 2]).abs().max())
    drm = float((rmse_k - rmse_p).abs().max())
    _require(dpos <= 1.0 and dang <= 2e-3 and drm <= 1.0,
             f"{what}: kernel vs plain pose {dpos} mm / {dang} rad, rmse {drm} mm")
    gap = int((it_k - it_p).abs().max())
    _require(gap <= 5, f"{what}: iterations {it_k.tolist()} vs {it_p.tolist()}")
    return got, (dpos, dang, drm, int(it_p.max())), plain_fn


def check_kernels(cfg) -> dict:
    """Phase 3: each kernel against its plain version on the card, at the
    slice's shapes (one robot: a leading axis of 1), with times.  Returns the
    kernels' rows (no launches)."""
    import torch

    from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import icp_fused
    from icp_slam_yolo_tpu_torch.ops.pallas.nn_kernel import nn_argmin, nn_argmin_plain
    from icp_slam_yolo_tpu_torch.ops.pallas import _lib
    from icp_slam_yolo_tpu_torch.ops.pallas.raster_fused import (
        CLUSTER,
        raster_plan,
        raster_update,
        raster_update_plain,
    )
    from icp_slam_yolo_tpu_torch.ops.raster import window_dims, world_to_px

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = cfg.n_max
    kernels = {}

    # K3: nearest neighbour, duplicated targets for ties
    base = rng.uniform(-5000, 5000, (n // 2, 2))
    tgt = torch.tensor(np.concatenate([base, base])[None], dtype=torch.float32, device=dev)  # duplicates: ties
    tv = torch.tensor(rng.random((1, n)) < 0.9, device=dev)
    src = torch.tensor(rng.uniform(-5000, 5000, (1, n, 2)), dtype=torch.float32, device=dev)
    d_k, i_k = nn_argmin(src, tgt, tv)
    d_p, i_p = nn_argmin_plain(src, tgt, tv)
    torch.cuda.synchronize()
    err3 = float((d_k - d_p).abs().max())
    _require(bool((i_k == i_p).all()), "K3: argmin differs from the plain version (ties go to the first index)")
    _require(err3 <= 1e-6 * float(d_p.abs().max()), f"K3: d2 error {err3}")
    picked3, layouts3 = k3_layouts(f"{n}x{n}", src, tgt, tv)
    ms3 = _device_ms(torch, lambda: nn_argmin(src, tgt, tv), 200)
    plain3 = _device_ms(torch, lambda: nn_argmin_plain(src, tgt, tv), 50)
    lib3 = _device_ms(torch, lambda: torch.cdist(src, tgt).min(2), 200)
    wall3 = _cuda_ms(torch, lambda: nn_argmin(src, tgt, tv), 200)
    nv = int(tv.sum())
    b3 = _bound(6.0 * n * nv, n * 8 + n * 9 + n * 8)
    kernels["nn_argmin"] = dict(
        name="nn_argmin", route="cuda", source="icp_slam_yolo_tpu_torch/csrc/nn.cu",
        replaces="icp_slam_yolo_tpu/ops/pallas/nn_kernel.py:76", max_abs_err=err3,
        ms=ms3, plain_ms=plain3, bound_ms=b3[0], bound_by=b3[1], library_ms=lib3)
    print(f"[3] K3 nn_argmin {n}x{n}: idx equal, max|d2 err| {err3:.3g} (tol 1e-6 rel), every layout the same bits; "
          f"layout {picked3} device {ms3 * 1e3:.2f} us (wall per call {wall3 * 1e3:.1f} us), plain {plain3 * 1e3:.2f} us, "
          f"cdist+min {lib3 * 1e3:.2f} us; us per layout (lanes x cluster): {layouts3}", flush=True)

    # K1: the ICP loop on a 24576-slot map holding 20k live points
    cap, n_map = cfg.map_capacity, 20000
    one, kw, truth = k1_registration(cfg, n_map, rng)
    (pose_k, rmse_k, _, it_k), (dpos, dang, drm, it_p), plain_fn = k1_against_plain("K1", one, kw)
    n_it = int(it_k)
    _require(float((pose_k[0, :2] - truth[:2]).norm()) < 30.0, "K1: did not recover the true pose")
    ms1 = _device_ms(torch, lambda: icp_fused(*one, **kw), 20)
    plain1 = _device_ms(torch, plain_fn, 3)
    # the same registration against 256 targets: what a sweep costs besides the pairs
    small = (*one[:2], one[2][:, :256].contiguous(), one[3][:, :256].contiguous(), one[4])
    it_small = int(icp_fused(*small, **kw)[3])
    sweep_small = _device_ms(torch, lambda: icp_fused(*small, **kw), 20) / (it_small + 1)
    n_src = int(one[1].sum())
    b1 = _bound(7.0 * n_src * n_map * (n_it + 1), n * 9 + cap * 9 + 16 + 32)
    kernels["icp_fused"] = dict(
        name="icp_fused", route="cuda", source="icp_slam_yolo_tpu_torch/csrc/icp.cu",
        replaces="icp_slam_yolo_tpu/ops/pallas/icp_fused.py:419", max_abs_err=max(dpos, drm),
        ms=ms1, plain_ms=plain1, bound_ms=b1[0], bound_by=b1[1], library_ms=None)
    print(f"[3] K1 icp_fused {n_src} live src x {n_map} live of {cap} tgt: pose err {dpos:.2g} mm / "
          f"{dang:.2g} rad, rmse err {drm:.2g} mm (tol 1 mm / 2e-3 rad / 1 mm), iters {n_it} vs "
          f"{it_p}; device {ms1 * 1e3:.1f} us = {ms1 * 1e3 / (n_it + 1):.2f} us per sweep "
          f"({n_it} iterations + the final sweep), plain {plain1:.2f} ms; against 256 targets "
          f"{sweep_small * 1e3:.2f} us per sweep", flush=True)

    # K2: the raster, 512 rays, some blocked by an occupied wall
    h, w = cfg.map.height_px, cfg.map.width_px
    occ = torch.full((1, h, w), 0.5, dtype=torch.float32, device=dev)
    occ[0, h // 2 - 60: h // 2 + 60, w // 2 + 40: w // 2 + 43] = 0.9  # occupied wall in front
    robot = torch.tensor([150.0, -90.0], device=dev)
    pts = torch.tensor(rng.uniform(-5000, 5000, (n, 2)), dtype=torch.float32, device=dev)
    live = torch.tensor(rng.random(n) < 0.95, device=dev)
    win = cfg.occupancy.window_px
    rx, ry = world_to_px(robot, cfg.map)
    ex, ey = world_to_px(pts, cfg.map)
    inwin = ((ex >= torch.clamp(rx - win, min=0)) & (ex < torch.clamp(rx + win, max=w))
             & (ey >= torch.clamp(ry - win, min=0)) & (ey < torch.clamp(ry + win, max=h)))
    side_y, side_x = window_dims(h, w, cfg.occupancy)
    y0 = torch.clamp(ry - win, 0, h - side_y)
    x0 = torch.clamp(rx - win, 0, w - side_x)
    meta = torch.stack([y0, x0, ry - y0, rx - x0]).to(torch.int32)
    args2 = (occ, meta[None], (ey - y0)[None].contiguous(), (ex - x0)[None].contiguous(),
             (live & inwin)[None].contiguous())
    kw2 = dict(side_y=side_y, side_x=side_x, k=cfg.occupancy.max_ray_px,
               p_occ_inc=cfg.occupancy.p_occ_inc, p_free_decay=cfg.occupancy.p_free_decay,
               block_threshold=cfg.occupancy.block_threshold)
    accept = torch.ones(1, dtype=torch.bool, device=dev)
    g_k = raster_update(*args2, accept, **kw2)
    g_p = raster_update_plain(*args2, accept, **kw2)
    torch.cuda.synchronize()
    err2 = float((g_k - g_p).abs().max())
    _require(err2 <= 1e-6, f"K2: grid error {err2}")
    changed = int(((g_p - occ).abs() > 0).sum())
    _require(changed > 0 and float(g_k[0, h // 2, w // 2 + 50]) == 0.5,
             "K2: the wall did not shadow the cells behind it")
    plan2 = raster_plan(1, h, w, side_y, side_x, n, kw2["k"])
    ms2 = _one_launch_ms(torch, lambda: raster_update(*args2, accept, **kw2), 200, "K2")
    k2_forced = lambda plan: raster_update(*args2, accept, **kw2, plan=plan)  # noqa: E731
    layouts2 = raster_layouts("K2", k2_forced, k2_forced, g_k, (1, h, w, side_y, side_x, n, kw2["k"]), 100)
    plain2 = _device_ms(torch, lambda: raster_update_plain(*args2, accept, **kw2), 20)
    n_rays = int((live & inwin).sum())
    visits = n_rays * (win + 1)
    # the work the function needs: the window read and written once, the
    # rays and the flag (the kernels line's bound, as the TPU kernel writes
    # the window alone); and as its contract has it here, with the new
    # grid's every other cell read and written once
    b2w = _bound(12.0 * visits + 20.0 * side_y * side_x, 2 * 4 * side_y * side_x + n * 9 + 16 + 1)
    b2 = _bound(12.0 * visits + 20.0 * side_y * side_x, 2 * 4 * h * w + n * 9 + 16 + 1)
    kernels["raster_update"] = dict(
        name="raster_update", route="cuda", source="icp_slam_yolo_tpu_torch/csrc/raster.cu",
        replaces="icp_slam_yolo_tpu/ops/pallas/raster_fused.py:352", max_abs_err=err2,
        ms=ms2, plain_ms=plain2, bound_ms=b2w[0], bound_by=b2w[1], library_ms=None)
    print(f"[3] K2 raster_update {n_rays} rays, window {side_y}x{side_x} of {h}x{w}: max err {err2:.2g} (tol 1e-6); "
          f"one launch a call, clusters of {CLUSTER} x {plan2.threads} threads ({plan2.copy_clusters} copying "
          f"clusters of {_lib.sm_count(dev)} SMs, {plan2.smem_bytes} bytes of shared memory a block): device "
          f"{ms2 * 1e3:.2f} us, plain {plain2 * 1e3:.1f} us; bound {b2w[0] * 1e3:.3f} us for the window alone, "
          f"{b2[0] * 1e3:.3f} us with the new grid's other cells ({b2w[1]}, {b2[1]}); every layout, same bits: "
          f"{layouts2}",
          flush=True)

    return kernels


def check_edge_cases(cfg) -> int:
    """Phase 3, continued: each kernel against its plain version at the edges
    the main path can reach but the shapes above do not: ragged source and
    target counts, no valid target, no live source row, Anderson(1), a
    single ray, no ray, a window clamped at the grid's corner, and a
    rejected scan (accept false) that must leave the grid as it was; K4 on
    the same grid (833 x 1000, not tile-shaped) must give K2's values; K2
    and K4 on a small window in both layouts, each the same bits, and with
    1100 rays a robot (three groups of rays).
    Returns the number of cases."""
    import torch

    from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import _finish, _prepare, icp_fused, icp_fused_plain
    from icp_slam_yolo_tpu_torch.ops.pallas.nn_kernel import nn_argmin, nn_argmin_plain
    from icp_slam_yolo_tpu_torch.ops.pallas.raster_fused import (
        raster_update,
        raster_update_grid,
        raster_update_grid_plain,
        raster_update_plain,
    )
    from icp_slam_yolo_tpu_torch.ops.raster import window_dims

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    n_cases = 0

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    def mask(a):
        return torch.tensor(np.asarray(a), dtype=torch.bool, device=dev)

    for s, t, frac in ((1, 1, 1.0), (37, 1000, 0.5), (300, 1537, 0.9), (64, 300, 0.0)):
        src = f32(rng.uniform(-3000, 3000, (1, s, 2)))
        tgt = f32(np.round(rng.uniform(-3000, 3000, (1, t, 2)) / 200.0) * 200.0)  # coarse grid: ties
        tv = mask(rng.random((1, t)) < frac)
        d_k, i_k = nn_argmin(src, tgt, tv)
        d_p, i_p = nn_argmin_plain(src, tgt, tv)
        _require(bool((i_k == i_p).all()) and bool((d_k == d_p).all()),
                 f"K3 edge case S={s} T={t} valid {frac}: kernel differs from plain")
        n_cases += 1

    room = warehouse_segments(4000.0, 3000.0)
    for s, t, frac_src, frac_tgt, anderson in ((40, 300, 1.0, 0.8, True), (300, 1000, 0.9, 0.9, False),
                                               (64, 256, 1.0, 0.0, False), (64, 256, 0.0, 1.0, False)):
        tgt_np = map_points_along(room, t, rng)
        src_np = map_points_along(room, s, rng, noise_mm=5.0) - np.array([60.0, -40.0])
        sv, tv = mask(rng.random((1, s)) < frac_src), mask(rng.random((1, t)) < frac_tgt)
        src, tgt, init = f32(src_np[None]), f32(tgt_np[None]), f32([[20.0, -10.0, 0.01]])
        kw = dict(iters=30, threshold_mm=cfg.icp.threshold_mm, tolerance=1e-3, anderson=anderson)
        pose_k, rmse_k, nin_k, it_k = icp_fused(src, sv, tgt, tv, init, **kw)
        params, tgt_c, c = _prepare(tgt, tv, init)
        pose_p, rmse_p, nin_p, _ = _finish(icp_fused_plain(
            src, sv, tgt_c, tv, params, iters=30, thr2=kw["threshold_mm"] ** 2, tolerance=1e-3,
            anderson=anderson), c)
        rmse_p = float(rmse_p)
        ok = (float((pose_k[:, :2] - pose_p[:, :2]).abs().max()) <= 1.0
              and float((pose_k[:, 2] - pose_p[:, 2]).abs().max()) <= 2e-3
              and abs(int(nin_k) - int(nin_p)) <= 2
              and (abs(float(rmse_k) - rmse_p) <= 1.0 if np.isfinite(rmse_p) else not np.isfinite(float(rmse_k))))
        _require(ok, f"K1 edge case S={s} T={t} src {frac_src} tgt {frac_tgt} anderson {anderson}: "
                     f"kernel {pose_k.tolist()} {float(rmse_k)} vs plain {pose_p.tolist()} {rmse_p}")
        n_cases += 1

    h, w = cfg.map.height_px, cfg.map.width_px
    side_y, side_x = window_dims(h, w, cfg.occupancy)
    occ = f32(rng.uniform(0.0, 1.0, (1, h, w)))  # many cells above the block threshold
    kw2 = dict(side_y=side_y, side_x=side_x, k=cfg.occupancy.max_ray_px, p_occ_inc=cfg.occupancy.p_occ_inc,
               p_free_decay=cfg.occupancy.p_free_decay, block_threshold=cfg.occupancy.block_threshold)
    win = cfg.occupancy.window_px
    for n, (ry, rx) in ((1, (400, 500)), (0, (400, 500)), (333, (3, 5)), (512, (h - 2, w - 1))):
        y0, x0 = min(max(ry - win, 0), h - side_y), min(max(rx - win, 0), w - side_x)
        meta = torch.tensor([[y0, x0, ry - y0, rx - x0]], dtype=torch.int32, device=dev)
        ey = torch.tensor(rng.integers(max(ry - win, 0), min(ry + win, h), (1, n)) - y0, dtype=torch.int32, device=dev)
        ex = torch.tensor(rng.integers(max(rx - win, 0), min(rx + win, w), (1, n)) - x0, dtype=torch.int32, device=dev)
        live = mask(rng.random((1, n)) < 0.9)
        for acc in (None, mask([True]), mask([False])):
            g_k = raster_update(occ, meta, ey, ex, live, acc, **kw2)
            err = float((g_k - raster_update_plain(occ, meta, ey, ex, live, acc, **kw2)).abs().max())
            _require(err <= 1e-6, f"K2 edge case {n} rays, robot cell ({ry}, {rx}), accept {acc}: "
                                  f"grid error {err}")
            _require(acc is None or bool(acc) or torch.equal(g_k, occ),
                     "K2: a rejected scan changed the grid")
            _require(torch.equal(raster_update_grid(occ.clone(), meta, ey, ex, live, acc, **kw2), g_k),
                     f"K4 on the {h}x{w} grid differs from K2 ({n} rays, robot cell ({ry}, {rx}), accept {acc})")
            n_cases += 1
    # both layouts on a small window: two robots on 100 x 122 grids (rows not 16-byte aligned: 4-byte
    # copies), the second off the grid, 64 x 64 windows, 30 samples
    hs, ws, side_s, win_s, n_s = 100, 122, 64, 26, 200
    occ_s = f32(np.where(rng.random((2, hs, ws)) < 0.05, 0.9, rng.uniform(0.2, 0.6, (2, hs, ws))))
    meta_s, eys, exs = [], [], []
    for ry, rx in ((50, 60), (-2, 118)):
        y0, x0 = min(max(ry - win_s, 0), hs - side_s), min(max(rx - win_s, 0), ws - side_s)
        meta_s.append([y0, x0, ry - y0, rx - x0])
        eys.append(rng.integers(max(ry - win_s, 0), min(ry + win_s, hs), n_s) - y0)
        exs.append(rng.integers(max(rx - win_s, 0), min(rx + win_s, ws), n_s) - x0)
    args_s = (torch.tensor(meta_s, dtype=torch.int32, device=dev),
              torch.tensor(np.array(eys), dtype=torch.int32, device=dev),
              torch.tensor(np.array(exs), dtype=torch.int32, device=dev), mask(rng.random((2, n_s)) < 0.9),
              mask([True, True]))
    kw_s = dict(kw2, side_y=side_s, side_x=side_s, k=30)
    g2 = raster_update(occ_s, *args_s, **kw_s)
    g4 = raster_update_grid(occ_s.clone(), *args_s, **kw_s)
    err = float((g2 - raster_update_plain(occ_s, *args_s, **kw_s)).abs().max())
    _require(err <= 1e-6 and torch.equal(g4, raster_update_grid_plain(occ_s.clone(), *args_s, **kw_s)),
             f"K2/K4 on a {side_s}x{side_s} window: K2 error {err}, or K4 differs from its plain version")
    shape_s = (2, hs, ws, side_s, side_s, n_s, 30)
    plans2, plans4 = raster_plans(shape_s), raster_plans(shape_s, True)
    _require(set(plans2) == set(plans4) == {512, 1024},
             f"K2/K4 on a {side_s}x{side_s} window: layouts that fit {sorted(plans2)}, {sorted(plans4)}")
    for t in plans2:
        _held_layout("K2", torch.equal(raster_update(occ_s, *args_s, **kw_s, plan=plans2[t]), g2),
                     f"K2 on a {side_s}x{side_s} window: {t} threads differ from the picked layout")
        _held_layout("K4", torch.equal(raster_update_grid(occ_s.clone(), *args_s, **kw_s, plan=plans4[t]), g4),
                     f"K4 on a {side_s}x{side_s} window: {t} threads differ from the picked layout")
    n_cases += 1
    # more rays than a block holds at a time (512): the rays go in three groups, in both thread counts
    n_l = 1100
    args_l = (args_s[0], torch.tensor(rng.integers(0, side_s, (2, n_l)), dtype=torch.int32, device=dev),
              torch.tensor(rng.integers(0, side_s, (2, n_l)), dtype=torch.int32, device=dev),
              mask(rng.random((2, n_l)) < 0.9), args_s[4])
    shape_l = (2, hs, ws, side_s, side_s, n_l, 30)
    plans4 = raster_plans(shape_l, True)
    for t, plan2 in raster_plans(shape_l).items():
        plan4 = plans4[t]
        g2 = raster_update(occ_s, *args_l, **kw_s, plan=plan2)
        err = float((g2 - raster_update_plain(occ_s, *args_l, **kw_s)).abs().max())
        _held_layout("K2", err <= 1e-6, f"K2 with {n_l} rays a robot, {t} threads: error {err}")
        _held_layout("K4", torch.equal(raster_update_grid(occ_s.clone(), *args_l, **kw_s, plan=plan4),
                                       raster_update_grid_plain(occ_s.clone(), *args_l, **kw_s)),
                     f"K4 with {n_l} rays a robot, {t} threads: differs from its plain version")
        n_cases += 1
    torch.cuda.synchronize()
    print(f"[3] edge cases: {n_cases} cases, every kernel equal to its plain version within the "
          f"tolerances above", flush=True)
    return n_cases


def check_large_window(cfg) -> None:
    """Phase 3, continued: K2 and K4 on a window of more than 384 cells a
    side with rays of more than 512 samples (``window_px`` 300: 640 x 640,
    ``max_ray_px`` 620), which they take in bands of rows: K2 on one robot
    whose window is clamped at the grid's corner (rays up to 639 cells), K4
    on 8 robots, in both thread layouts, each the plain version's bits and
    one kernel event a call, timed beside the presets' 384 x 384 window at
    the same robots.  Then the band loop's other branches, each the plain
    version's bits in both layouts: K4 with one robot's flag false, K2 with
    its flag false and with no ray, and a 385 x 2432 window (400 x 2448
    grids, rays up to 2431 samples) whose last band leaves 15 of the 16
    ranks no row."""
    import torch

    from icp_slam_yolo_tpu_torch.ops.pallas.raster_fused import (
        CLUSTER,
        band_rows,
        raster_update,
        raster_update_grid,
        raster_update_grid_plain,
        raster_update_plain,
    )
    from icp_slam_yolo_tpu_torch.ops.raster import window_dims

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    h, w = cfg.map.height_px, cfg.map.width_px
    occ_np = np.where(rng.random((8, h, w)) < 0.002, 0.9, rng.uniform(0.2, 0.6, (8, h, w))).astype(np.float32)
    occ_np[:, 300:700, 600:603] = 0.9  # a wall some rays stop at
    lines = []
    for label, occ_cfg in (("presets' window", cfg.occupancy),
                           ("large window", dataclasses.replace(cfg.occupancy, window_px=300, max_ray_px=620))):
        side_y, side_x = window_dims(h, w, occ_cfg)
        win, k, n = occ_cfg.window_px, occ_cfg.max_ray_px, 512
        meta, eys, exs = [], [], []
        for r in range(8):
            ry, rx = (h - 3, 4) if r == 0 else (int(rng.integers(0, h)), int(rng.integers(0, w)))
            y0, x0 = min(max(ry - win, 0), h - side_y), min(max(rx - win, 0), w - side_x)
            meta.append([y0, x0, ry - y0, rx - x0])
            eys.append(rng.integers(0, side_y, n))
            exs.append(rng.integers(0, side_x, n))
        if label == "large window":  # robot 0's longest rays: to the window's far corners
            eys[0][:3], exs[0][:3] = [0, 0, side_y - 1], [side_x - 1, side_x // 2, side_x - 1]
        args = (torch.tensor(meta, dtype=torch.int32, device=dev),
                torch.tensor(np.array(eys), dtype=torch.int32, device=dev),
                torch.tensor(np.array(exs), dtype=torch.int32, device=dev),
                torch.tensor(rng.random((8, n)) < 0.9, device=dev), torch.ones(8, dtype=torch.bool, device=dev))
        kw = dict(side_y=side_y, side_x=side_x, k=k, p_occ_inc=occ_cfg.p_occ_inc,
                  p_free_decay=occ_cfg.p_free_decay, block_threshold=occ_cfg.block_threshold)
        occ8 = torch.tensor(occ_np, device=dev)
        occ1, args1 = occ8[:1].contiguous(), tuple(a[:1].contiguous() for a in args)
        want2 = raster_update_plain(occ1, *args1, **kw)
        want4 = raster_update_grid_plain(occ8.clone(), *args, **kw)
        times = []
        plans2, plans4 = raster_plans((1, h, w, side_y, side_x, n, k)), raster_plans((8, h, w, side_y, side_x, n, k), True)
        _require(set(plans2) == set(plans4) == {512, 1024}, f"K2/K4, {label}: layouts {plans2}, {plans4}")
        for t, plan2 in plans2.items():
            plan4 = plans4[t]
            _require(label != "large window" or (plan2.bands > 1 and plan4.bands > 1),
                     f"K2/K4, {label}: one band ({plan2}, {plan4})")
            _require(label == "large window" or (plan2.bands == 1 and plan4.bands == 1),
                     f"K2/K4, {label}: more than one band ({plan2}, {plan4})")
            _held_layout("K2", torch.equal(raster_update(occ1, *args1, **kw, plan=plan2), want2),
                         f"K2, {label} {side_y}x{side_x}, k {k}, {t} threads: not the plain version's bits")
            grid = occ8.clone()
            _held_layout("K4", torch.equal(raster_update_grid(grid, *args, **kw, plan=plan4), want4),
                         f"K4, {label} {side_y}x{side_x}, k {k}, {t} threads: not the plain version's bits")
            ms2 = _one_launch_ms(torch, lambda: raster_update(occ1, *args1, **kw, plan=plan2), 100, f"K2 {label}")
            ms4 = _one_launch_ms(torch, lambda: raster_update_grid(grid, *args, **kw, plan=plan4), 100,
                                 f"K4 {label}")
            times.append(f"{t} threads ({plan2.bands} band{'s' if plan2.bands > 1 else ''}, {plan2.smem_bytes} "
                         f"bytes of shared memory a block): K2 {ms2 * 1e3:.2f} us, K4 B = 8 {ms4 * 1e3:.2f} us")
        changed = int((want4 != occ8).sum())
        _require(changed > 0, f"K2/K4, {label}: no cell changed")
        lines.append(f"{label} {side_y}x{side_x}, k {k}, {n} rays a robot ({changed} cells of 8 grids changed): "
                     + "; ".join(times))
    print("[3] K2/K4, the plain version's bits, one launch a call: " + " | ".join(lines), flush=True)

    # the band loop's other branches on the large window (the last `args`, `kw`, `occ8`)
    off = args[4].clone()
    off[3] = False
    reject = torch.zeros(1, dtype=torch.bool, device=dev)
    none = tuple(torch.zeros((1, 0), dtype=x.dtype, device=dev) for x in args[1:4])  # ey, ex, live: no ray
    want_off = raster_update_grid_plain(occ8.clone(), *args[:4], off, **kw)
    want_none = raster_update_plain(occ1, args1[0], *none, args1[4], **kw)
    _require(torch.equal(want_off[3], occ8[3]) and not torch.equal(want_off, occ8),
             "K4, large window, robot 3's flag false: the plain version's grids are not as meant")
    # a 385 x 2432 window, two robots: the last band holds one row of rank 0 and none of the others
    hw, ww, sy, sx, kk = 400, 2448, 385, 2432, 2500
    occ_w = torch.tensor(np.where(rng.random((2, hw, ww)) < 0.002, 0.9, rng.uniform(0.2, 0.6, (2, hw, ww))),
                         dtype=torch.float32, device=dev)
    meta_w = torch.tensor([[7, 9, 200, 1200], [15, 16, sy - 3, 2]], dtype=torch.int32, device=dev)
    ey_w = torch.tensor(rng.integers(0, sy, (2, n)), dtype=torch.int32, device=dev)
    ex_w = torch.tensor(rng.integers(0, sx, (2, n)), dtype=torch.int32, device=dev)
    ex_w[1, :4] = sx - 1  # robot 1's longest rays: across the whole window
    args_w = (meta_w, ey_w, ex_w, torch.tensor(rng.random((2, n)) < 0.9, device=dev),
              torch.ones(2, dtype=torch.bool, device=dev))
    kw_w = dict(kw, side_y=sy, side_x=sx, k=kk)
    want_w2 = raster_update_plain(occ_w[:1].contiguous(), *(a[:1].contiguous() for a in args_w), **kw_w)
    want_w4 = raster_update_grid_plain(occ_w.clone(), *args_w, **kw_w)
    plans = []
    wide2, wide4 = raster_plans((1, hw, ww, sy, sx, n, kk)), raster_plans((2, hw, ww, sy, sx, n, kk), True)
    _require(set(wide2) == set(wide4) == set(plans2), f"K2/K4, {sy}x{sx} window: layouts {wide2}, {wide4}")
    for t in plans2:
        _held_layout("K4", torch.equal(raster_update_grid(occ8.clone(), *args[:4], off, **kw, plan=plans4[t]),
                                       want_off),
                     f"K4, large window, robot 3's flag false, {t} threads: not the plain version's bits")
        _held_layout("K2", torch.equal(raster_update(occ1, *args1[:4], reject, **kw, plan=plans2[t]), occ1),
                     f"K2, large window, flag false, {t} threads: the grid changed")
        _held_layout("K2", torch.equal(raster_update(occ1, args1[0], *none, args1[4], **kw, plan=plans2[t]),
                                       want_none),
                     f"K2, large window, no ray, {t} threads: not the plain version's bits")
        plan = wide4[t]
        rows = band_rows(sy, plan.bands)
        _require(-(-(sy - (CLUSTER - 1)) // CLUSTER) <= (plan.bands - 1) * rows,
                 f"K2/K4, {sy}x{sx} window, {t} threads: every rank has rows in the last band ({plan})")
        _held_layout("K2", torch.equal(raster_update(occ_w[:1].contiguous(), *(a[:1].contiguous() for a in args_w),
                                                     **kw_w, plan=wide2[t]), want_w2),
                     f"K2, {sy}x{sx} window, k {kk}, {t} threads: not the plain version's bits")
        _held_layout("K4", torch.equal(raster_update_grid(occ_w.clone(), *args_w, **kw_w, plan=plan), want_w4),
                     f"K4, {sy}x{sx} window, k {kk}, {t} threads: not the plain version's bits")
        plans.append(f"{t} threads {plan.bands} bands of {CLUSTER} x {rows} rows")
    _require(not torch.equal(want_w4, occ_w), f"K4, {sy}x{sx} window: no cell changed")
    print(f"[3] K2/K4 on the large window, the plain version's bits in both layouts: K4 with robot 3's flag false, "
          f"K2 with its flag false, K2 with no ray; a {sy}x{sx} window of {hw}x{ww} grids, k {kk}, rays to "
          f"{sx - 1} samples, 15 ranks without a row in the last band ({'; '.join(plans)})", flush=True)


def replay(cfg, n_scans: int = 150, n_cpu: int = 8) -> tuple[dict, float]:
    """Phase 4: ``Slam(cfg).run`` on the card over a synthetic warehouse with
    the launch counters reset just before and read just after, checked
    against ground truth; then the first ``n_cpu`` scans on the CPU (plain
    versions) against the card's run.  Returns ``(launches, scans/s)``."""
    import torch

    import icp_slam_yolo_tpu_torch as port
    from icp_slam_yolo_tpu_torch.ops import pallas

    cap, h, w = cfg.map_capacity, cfg.map.height_px, cfg.map.width_px
    padded, gt = padded_sequence(n_scans, 7, cfg.n_max)
    port.Slam(cfg).run(padded[:4])  # warm-up: CUDA context and caching allocator
    torch.cuda.synchronize()
    pallas.reset_launches()
    t0 = time.perf_counter()
    slam = port.Slam(cfg)
    state, outs = slam.run(padded)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(pallas.LAUNCHES)
    acc = outs.accepted.cpu().numpy()
    rmse = outs.rmse.cpu().numpy()
    poses = outs.pose.cpu().numpy()
    pos_err, ang_err, _ = trajectory_errors(poses, gt)
    n_map_pts = int(state.map_valid.sum())
    print(f"[4] replay {n_scans} scans at full width (n_max {cfg.n_max}, map {cap}, grid {h}x{w}): "
          f"{n_scans / secs:.1f} scans/s; accepted {acc.mean():.4f}; median rmse "
          f"{np.median(rmse[acc]):.2f} mm; trajectory error max {pos_err.max():.1f} mm, final "
          f"{pos_err[-1]:.1f} mm over {np.hypot(*np.diff(gt[:, :2], axis=0).T).sum() / 1e3:.1f} m, "
          f"heading max {ang_err.max():.4f} rad; map points {n_map_pts}; mean ICP iterations "
          f"{outs.n_iters.float().mean():.1f}; mean gated points per scan {outs.n_points.float().mean():.1f}; "
          f"launches {launches}", flush=True)
    for name in ("icp_fused", "raster_update", "nn_argmin"):
        _require(launches[name] > 0, f"the slice path never launched {name}")
    check_quality("slice", cfg, acc, rmse, poses, gt, state)

    # the step enqueues its work without waiting for the card: PyTorch's sync
    # debug mode raises on each synchronising call it detects
    from icp_slam_yolo_tpu_torch.slam import pipeline

    scans_dev = torch.from_numpy(padded[:6]).to("cuda")
    step = pipeline.make_step(cfg)
    st = pipeline.init_state(scans_dev[0], cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(1, 6):
            st, _ = step(st, scans_dev[t])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("[4] 5 steps under torch.cuda.set_sync_debug_mode('error'): no host synchronisation", flush=True)

    # where the device time of a step goes, over a short window under the profiler
    n_win = 21
    print(f"[4] profiled {n_win - 1} steps: " + profile_window(torch, lambda: port.Slam(cfg).run(padded[:n_win]), n_win - 1),
          flush=True)

    t0 = time.perf_counter()
    _, outs_cpu = port.run_sequence(padded[:n_cpu], cfg, device="cpu")
    cpu_secs = time.perf_counter() - t0
    acc_c = outs_cpu.accepted.numpy()
    dpose = np.abs(outs_cpu.pose.numpy() - poses[: n_cpu - 1])
    print(f"[4] cpu replay of {n_cpu} scans ({cpu_secs:.1f} s): accept flags equal "
          f"{bool((acc_c == acc[: n_cpu - 1]).all())}, max pose diff {dpose[:, :2].max():.3g} mm / "
          f"{dpose[:, 2].max():.3g} rad (tol 2 mm / 2e-3 rad)", flush=True)
    _require(bool((acc_c == acc[: n_cpu - 1]).all()), "cpu and card accept flags differ")
    _require(dpose[:, :2].max() <= 2.0 and dpose[:, 2].max() <= 2e-3, "cpu and card poses differ")

    return launches, n_scans / secs


def k3_layouts(name, src, tgt, tv):
    """K3 in the layout its plan picks, against the plain version, and in
    every layout of `nn_kernel.layouts`, each required to give the same
    bits: ``(the picked layout, device us of every layout)``."""
    import torch

    from icp_slam_yolo_tpu_torch.ops.pallas import _lib
    from icp_slam_yolo_tpu_torch.ops.pallas.nn_kernel import layouts, nn_argmin, nn_argmin_plain, nn_plan

    d_k, i_k = nn_argmin(src, tgt, tv)
    d_p, i_p = nn_argmin_plain(src, tgt, tv)
    _require(torch.equal(i_k, i_p) and torch.equal(d_k, d_p), f"K3 {name}: kernel differs from the plain version")
    shape = (src.shape[0], src.shape[1], tgt.shape[1], _lib.sm_count(src.device))
    picked = nn_plan(*shape)
    times = []
    for plan in layouts(*shape):
        d_f, i_f = nn_argmin(src, tgt, tv, plan=plan)
        _held_layout("K3", torch.equal(i_f, i_k) and torch.equal(d_f, d_k),
                     f"K3 {name}: layout {plan} differs from the picked {picked}")
        t_ms = _device_ms(torch, lambda: nn_argmin(src, tgt, tv, plan=plan), 50)
        times.append(f"{plan.lanes}x{plan.cluster} {t_ms * 1e3:.2f}")
    return picked, "; ".join(times)


def k1_layouts(what: str, args: tuple, kw: dict, picked: tuple) -> str:
    """Every other layout of `icp_fused.layouts` at these registrations'
    shapes, each required to give ``picked``'s bits (the picked layout's
    results); CUDA-event times of the pick and the fastest three others."""
    import torch

    from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import card, card_plan, icp_fused, layouts

    dev = args[0].device
    b, s, t = args[0].shape[0], args[0].shape[1], args[2].shape[1]
    plan = card_plan(b, s, t, dev)
    times = []
    for other in layouts(b, s, t, card(dev)):
        if other == plan:
            continue
        got = icp_fused(*args, **kw, plan=other)
        _held_layout("K1", all(torch.equal(x, y) for x, y in zip(got, picked)),
                     f"{what}: layout {other[:3]} differs from the picked {plan[:3]}")
        times.append((_cuda_ms(torch, lambda: icp_fused(*args, **kw, plan=other), 3), other))
    _require(len(times) > 0, f"{what}: no other layout fits")
    pick_ms = _cuda_ms(torch, lambda: icp_fused(*args, **kw), 3)

    def name(p):
        return f"{p.row_groups} x {p.slices} {'cluster' if p.cluster else 'grid'}"

    fastest = ", ".join(f"{name(p)} {ms * 1e3:.1f} us" for ms, p in sorted(times, key=lambda x: x[0])[:3])
    return (f"{len(times)} other layouts, same bits; wall per call {pick_ms * 1e3:.1f} us picked, fastest others "
            f"{fastest}")


def check_batched_kernels(cfg) -> tuple[dict, dict]:
    """Phase 3, continued: the robot axis.  K4 against its plain version at
    B = 8 on the fleet's 864 x 1024 grids; K1 at B = 8 against its plain
    version and against 8 single launches, and at B = 64; K3 batched with
    ties and at the rescue's 512 x 24576.  Returns ``(K4's row, the batched
    times)``."""
    import torch

    from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import _finish, _prepare, card_plan, icp_fused, icp_fused_plain
    from icp_slam_yolo_tpu_torch.ops.pallas import _lib
    from icp_slam_yolo_tpu_torch.ops.pallas.nn_kernel import nn_argmin, nn_argmin_plain
    from icp_slam_yolo_tpu_torch.ops.pallas.raster_fused import (
        CLUSTER,
        raster_plan,
        raster_update_grid,
        raster_update_grid_plain,
    )
    from icp_slam_yolo_tpu_torch.ops.raster import window_dims

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    n, cap = cfg.n_max, cfg.map_capacity
    batched = {}

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    # K4: 8 robots at different window origins, one clamped at a corner, one
    # with its flag false, one without a live ray
    b = 8
    h, w = cfg.map.height_px, cfg.map.width_px
    win = cfg.occupancy.window_px
    side_y, side_x = window_dims(h, w, cfg.occupancy)
    # mostly unknown or free cells with sparse obstacles, so most rays run a long way
    occ = f32(np.where(rng.random((b, h, w)) < 0.01, 0.9, rng.uniform(0.2, 0.6, (b, h, w))))
    cells = [(400, 500), (3, 5), (h - 2, w - 1), (100, 900), (700, 80), (432, 512), (10, 1000), (860, 10)]
    meta, eys, exs = [], [], []
    for ry, rx in cells:
        y0, x0 = min(max(ry - win, 0), h - side_y), min(max(rx - win, 0), w - side_x)
        meta.append([y0, x0, ry - y0, rx - x0])
        eys.append(rng.integers(max(ry - win, 0), min(ry + win, h), n) - y0)
        exs.append(rng.integers(max(rx - win, 0), min(rx + win, w), n) - x0)
    meta = torch.tensor(meta, dtype=torch.int32, device=dev)
    ey = torch.tensor(np.array(eys), dtype=torch.int32, device=dev)
    ex = torch.tensor(np.array(exs), dtype=torch.int32, device=dev)
    live = torch.tensor(rng.random((b, n)) < 0.9, device=dev)
    live[5] = False
    accept = torch.ones(b, dtype=torch.bool, device=dev)
    accept[3] = False
    kw4 = dict(side_y=side_y, side_x=side_x, k=cfg.occupancy.max_ray_px, p_occ_inc=cfg.occupancy.p_occ_inc,
               p_free_decay=cfg.occupancy.p_free_decay, block_threshold=cfg.occupancy.block_threshold)
    g_k = raster_update_grid(occ.clone(), meta, ey, ex, live, accept, **kw4)
    g_p = raster_update_grid_plain(occ.clone(), meta, ey, ex, live, accept, **kw4)
    torch.cuda.synchronize()
    err4 = float((g_k - g_p).abs().max())
    changed = (g_p != occ).flatten(1).sum(1)
    _require(err4 == 0.0, f"K4: grid differs from the plain version by {err4}")
    _require(int(changed[3]) == 0 and int(changed[5]) == 0 and int(changed.sum()) > 10000,
             f"K4: cells changed per robot {changed.tolist()} (robot 3 has its flag false, robot 5 no live ray)")
    for acc in (None, torch.zeros(b, dtype=torch.bool, device=dev)):
        g = raster_update_grid(occ.clone(), meta, ey, ex, live, acc, **kw4)
        _require(torch.equal(g, raster_update_grid_plain(occ.clone(), meta, ey, ex, live, acc, **kw4)),
                 "K4: differs from the plain version without flags / with all flags false")
    work = occ.clone()
    ms4 = _one_launch_ms(torch, lambda: raster_update_grid(work, meta, ey, ex, live, accept, **kw4), 100, "K4 B=8")
    layouts4 = raster_layouts(
        "K4 B=8", lambda plan: raster_update_grid(occ.clone(), meta, ey, ex, live, accept, **kw4, plan=plan),
        lambda plan: raster_update_grid(work, meta, ey, ex, live, accept, **kw4, plan=plan), g_k,
        (b, h, w, side_y, side_x, n, kw4["k"]), 50, in_place=True)
    plan4 = raster_plan(b, h, w, side_y, side_x, n, kw4["k"], in_place=True,
                        capacity=_lib.lib().slam_raster_max_clusters(side_y, side_x, 1024, 1))
    work_p = occ.clone()
    plain4 = _device_ms(torch, lambda: raster_update_grid_plain(work_p, meta, ey, ex, live, accept, **kw4), 10)
    def k4_bound(live_, accept_):
        """The work the function needs: the window of each robot that has a
        ray to draw (flag true, a live ray) read and written once, and every
        robot's rays, origin and flag."""
        rays = int((live_ & accept_[:, None]).sum())
        active = int((accept_ & live_.any(1)).sum())
        return rays, active, _bound(12.0 * rays * (win + 1) + 20.0 * active * side_y * side_x,
                                    active * 2 * 4 * side_y * side_x + live_.shape[0] * (n * 9 + 16 + 1))

    n_rays, n_active, b4 = k4_bound(live, accept)
    k4_row = dict(
        name="raster_update_grid", route="cuda", source="icp_slam_yolo_tpu_torch/csrc/raster.cu",
        replaces="icp_slam_yolo_tpu/ops/pallas/raster_fused.py:482", max_abs_err=err4,
        ms=ms4, plain_ms=plain4, bound_ms=b4[0], bound_by=b4[1], library_ms=None)
    print(f"[3] K4 raster_update_grid B={b}, {n_rays} rays of {n_active} robots with work, windows {side_y}x{side_x} "
          f"of {h}x{w}: equal to the plain version, cells changed per robot {changed.tolist()}; one launch a call, "
          f"a cluster of {CLUSTER} a robot x {plan4.threads} threads ({plan4.smem_bytes} bytes of shared memory a "
          f"block; the card holds {_lib.lib().slam_raster_max_clusters(side_y, side_x, 1024, 1)} clusters of {CLUSTER} x "
          f"1024, {_lib.lib().slam_raster_max_clusters(side_y, side_x, 512, 1)} of {CLUSTER} x 512 at once): device "
          f"{ms4 * 1e3:.2f} us, plain {plain4 * 1e3:.1f} us, bound {b4[0] * 1e3:.3f} us ({b4[1]}); every layout, "
          f"same bits: {layouts4}", flush=True)
    # the same 8 robots tiled to 64
    wide = [x.repeat(8, *([1] * (x.dim() - 1))) for x in (occ, meta, ey, ex, live, accept)]
    g_w = raster_update_grid(wide[0].clone(), *wide[1:], **kw4)
    _require(torch.equal(g_w, g_k.repeat(8, 1, 1)), "K4 B=64: lanes fed the same robot differ from the B=8 result")
    _require(torch.equal(g_w, raster_update_grid_plain(wide[0].clone(), *wide[1:], **kw4)),
             "K4 B=64: differs from the plain version")
    work_w = wide[0].clone()
    ms4w = _one_launch_ms(torch, lambda: raster_update_grid(work_w, *wide[1:], **kw4), 50, "K4 B=64")
    layouts4w = raster_layouts(
        "K4 B=64", lambda plan: raster_update_grid(wide[0].clone(), *wide[1:], **kw4, plan=plan),
        lambda plan: raster_update_grid(work_w, *wide[1:], **kw4, plan=plan), g_w,
        (64, h, w, side_y, side_x, n, kw4["k"]), 20, in_place=True)
    _, n_active_w, b4w = k4_bound(wide[4], wide[5])
    work_wp = wide[0].clone()
    plain4w = _device_ms(torch, lambda: raster_update_grid_plain(work_wp, *wide[1:], **kw4), 3)
    batched["raster_update_grid_b64"] = dict(ms=ms4w, plain_ms=plain4w, bound_ms=b4w[0])
    print(f"[3] K4 raster_update_grid B=64 (the 8 robots tiled, {n_active_w} with work): equal to the B=8 result "
          f"lane by lane and to the plain version; device {ms4w * 1e3:.2f} us, plain {plain4w * 1e3:.1f} us, bound "
          f"{b4w[0] * 1e3:.2f} us ({b4w[1]}); every layout, same bits: {layouts4w}", flush=True)

    # K1 batched: 8 distinct registrations on 24576-slot maps with 20k live
    # points, and the same 8 tiled to 64
    segs = warehouse_segments(10000.0, 6000.0)
    n_map, n_src = 20000, 260

    def problems(count):
        maps = np.zeros((count, cap, 2), np.float32)
        srcs = np.zeros((count, n, 2), np.float32)
        for r in range(count):
            g = np.random.default_rng(100 + r % 8)
            maps[r, :n_map] = map_points_along(segs, n_map, g)
            th = 0.02 * (r % 8 - 3)
            c, s = np.cos(th), np.sin(th)
            pts = map_points_along(segs, n_src, g, noise_mm=5.0) - np.array([40.0 * (r % 8) - 100.0, 30.0])
            srcs[r, :n_src] = pts @ np.array([[c, -s], [s, c]])
        sv = torch.zeros((count, n), dtype=torch.bool, device=dev)
        sv[:, :n_src] = True
        mv = torch.zeros((count, cap), dtype=torch.bool, device=dev)
        mv[:, :n_map] = True
        return f32(srcs), sv, f32(maps), mv, torch.zeros((count, 3), dtype=torch.float32, device=dev)

    kw = dict(iters=cfg.icp.max_iterations, threshold_mm=cfg.icp.threshold_mm, tolerance=cfg.icp.tolerance)
    for count in (1, 8, 64):
        a = problems(count)
        pose, rmse, n_in, its = icp_fused(*a, **kw)
        torch.cuda.synchronize()
        ms1 = _device_ms(torch, lambda: icp_fused(*a, **kw), 5)
        kernel_ms = _device_profile(torch, lambda: icp_fused(*a, **kw), 5)
        k_ms = max(kernel_ms.values())  # the cooperative kernel itself
        sweeps = its.to(torch.float64) + 1.0
        bound = _bound(7.0 * n_src * n_map * float(sweeps.sum()), count * (n * 9 + cap * 9 + 16 + 32))
        # the same registrations against their first 256 targets: what a sweep costs besides the pairs
        small = (a[0], a[1], a[2][:, :256].contiguous(), a[3][:, :256].contiguous(), a[4])
        sweeps_small = float(icp_fused(*small, **kw)[3].max()) + 1.0
        fixed = max(_device_profile(torch, lambda: icp_fused(*small, **kw), 10).values()) / sweeps_small
        plan = card_plan(count, n, cap, dev)
        layout = f"{plan.row_groups} x {plan.slices} {'cluster' if plan.cluster else 'grid'}"
        batched[f"icp_fused_b{count}"] = dict(ms=ms1, kernel_ms=k_ms, bound_ms=bound[0], iters=its.tolist(),
                                              sweep_ms=k_ms / float(sweeps.max()), fixed_sweep_ms=fixed,
                                              plan=layout)
        line = (f"[3] K1 icp_fused B={count} ({n_src} live src x {n_map} live of {cap} tgt each, tolerance "
                f"{cfg.icp.tolerance}; layout {layout}: {plan.row_groups} row groups x {plan.slices} slices, "
                f"{count * plan.row_groups * plan.slices} blocks): device {ms1 * 1e3:.1f} us per launch (kernel "
                f"{k_ms * 1e3:.1f} us), {ms1 * 1e3 / count:.1f} us per registration, "
                f"{k_ms * 1e3 / float(sweeps.max()):.2f} us per sweep of the longest registration; against 256 "
                f"targets {fixed * 1e3:.2f} us per sweep; iterations {its.tolist()[:8]}, bound {bound[0] * 1e3:.2f} us "
                f"({bound[1]})")
        line += "; " + k1_layouts(f"K1 B={count}", a, kw, (pose, rmse, n_in, its))
        if count == 8:
            params, tgt_c, c = _prepare(a[2], a[3], a[4])
            plain_fn = lambda: icp_fused_plain(a[0], a[1], tgt_c, a[3], params, iters=kw["iters"],  # noqa: E731
                                               thr2=kw["threshold_mm"] ** 2, tolerance=kw["tolerance"], anderson=False)
            pose_p, rmse_p, nin_p, its_p = _finish(plain_fn(), c)
            dpos = float((pose[:, :2] - pose_p[:, :2]).abs().max())
            dang = float((pose[:, 2] - pose_p[:, 2]).abs().max())
            drm = float((rmse - rmse_p).abs().max())
            _require(dpos <= 1.0 and dang <= 2e-3 and drm <= 1.0,
                     f"K1 B=8: kernel vs plain pose {dpos} mm / {dang} rad, rmse {drm} mm")
            _require(int((its - its_p).abs().max()) <= 5, f"K1 B=8: iterations {its.tolist()} vs {its_p.tolist()}")
            _require(len(set(its.tolist())) > 1, "K1 B=8: the registrations were meant to end at different iterations")
            singles = [icp_fused(*(x[r: r + 1] for x in a), **kw) for r in range(count)]
            ds = max(float((singles[r][0][0] - pose[r]).abs().max()) for r in range(count))
            bits = all(torch.equal(singles[r][0][0], pose[r]) for r in range(count))
            _require(bits and all(int(singles[r][3]) == int(its[r]) for r in range(count)),
                     f"K1 B=8 vs 8 single launches: poses not bit equal (max diff {ds})")
            plain8 = _device_ms(torch, plain_fn, 2)
            batched["icp_fused_b8"]["plain_ms"] = plain8
            line += (f"; vs plain: {dpos:.2g} mm / {dang:.2g} rad / rmse {drm:.2g} mm (tol 1 mm / 2e-3 rad / 1 mm), "
                     f"plain {plain8:.1f} ms; vs 8 single launches: poses bit equal")
        if count == 64:
            _require(all(torch.equal(pose[r], pose[r % 8]) for r in range(count)),
                     "K1 B=64: lanes fed the same problem gave different poses")
            params, tgt_c, c = _prepare(a[2], a[3], a[4])
            plain64 = _device_ms(torch, lambda: icp_fused_plain(
                a[0], a[1], tgt_c, a[3], params, iters=kw["iters"], thr2=kw["threshold_mm"] ** 2,
                tolerance=kw["tolerance"], anderson=False), 1)
            batched["icp_fused_b64"]["plain_ms"] = plain64
            line += f"; the 8 lanes of each problem bit equal; plain {plain64:.1f} ms"
        print(line, flush=True)

    # K3 batched with ties (B = 8, and the same tiled to 64), and at the rescue's 512 x 24576
    base = rng.uniform(-5000, 5000, (8, n // 2, 2))
    tgt8 = f32(np.concatenate([base, base], axis=1))
    tv8 = torch.tensor(rng.random((8, n)) < 0.9, device=dev)
    tv8[6] = False
    src8 = f32(rng.uniform(-5000, 5000, (8, n, 2)))
    for count in (8, 64):
        src, tgt, tv = (x.repeat(count // 8, *([1] * (x.dim() - 1))).contiguous() for x in (src8, tgt8, tv8))
        picked, layouts = k3_layouts(f"B={count}", src, tgt, tv)
        ms3 = _device_ms(torch, lambda: nn_argmin(src, tgt, tv), 100)
        plain3 = _device_ms(torch, lambda: nn_argmin_plain(src, tgt, tv), 20)
        lib3 = _device_ms(torch, lambda: torch.cdist(src, tgt).min(2), 100)
        b3 = _bound(6.0 * n * int(tv.sum()), count * (n * 8 + n * 9 + n * 8))
        batched[f"nn_argmin_b{count}"] = dict(ms=ms3, plain_ms=plain3, library_ms=lib3, bound_ms=b3[0])
        print(f"[3] K3 nn_argmin B={count} {n}x{n} with ties: equal to the plain version, every layout the same bits; "
              f"layout {picked} device {ms3 * 1e3:.2f} us, plain {plain3 * 1e3:.1f} us, cdist+min {lib3 * 1e3:.1f} us, "
              f"bound {b3[0] * 1e3:.4f} us ({b3[1]}); us per layout (lanes x cluster): {layouts}", flush=True)
    # the rescue's shape: map points duplicated T/2 apart, so ties straddle the cluster's slices
    half = map_points_along(segs, cap // 2, np.random.default_rng(11))
    tgt1 = f32(np.concatenate([half, half])[None])
    tv1 = torch.tensor(np.random.default_rng(12).random((1, cap)) < n_map / cap, device=dev)
    src1 = problems(1)[0]
    picked, layouts = k3_layouts(f"{n}x{cap}", src1, tgt1, tv1)
    ms3r = _device_ms(torch, lambda: nn_argmin(src1, tgt1, tv1), 50)
    plain3r = _device_ms(torch, lambda: nn_argmin_plain(src1, tgt1, tv1), 10)
    lib3r = _device_ms(torch, lambda: torch.cdist(src1, tgt1).min(2), 50)
    nv = int(tv1.sum())
    b3r = _bound(6.0 * n * nv, n * 8 + cap * 9 + n * 8)
    batched["nn_argmin_rescue"] = dict(ms=ms3r, plain_ms=plain3r, library_ms=lib3r, bound_ms=b3r[0])
    _require(ms3r < lib3r, f"K3 {n}x{cap}: {ms3r * 1e3:.2f} us, not below cdist+min's {lib3r * 1e3:.2f} us")
    print(f"[3] K3 nn_argmin {n}x{cap} (the rescue's shape, {nv} valid, duplicated {cap // 2} apart): equal to the plain "
          f"version, every layout the same bits; layout {picked} device {ms3r * 1e3:.2f} us, plain {plain3r * 1e3:.1f} us, "
          f"cdist+min {lib3r * 1e3:.1f} us, bound {b3r[0] * 1e3:.3f} us ({b3r[1]}); us per layout (lanes x cluster): "
          f"{layouts}", flush=True)
    return k4_row, batched


def _topk_outlier(xy, valid, k: int, ratio: float):
    """The library yardstick: the filter as the port took it before K9, a
    Gram ``bmm`` into a ``(B, N, N)`` matrix, ``torch.topk`` and float32
    statistics."""
    import torch

    w = valid.to(torch.float32)
    denom = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    p = (xy - (xy * w[..., None]).sum(-2, keepdim=True) / denom[..., None]) * 1e-3
    sn = (p * p).sum(-1)
    d2 = torch.clamp(sn[..., :, None] + sn[..., None, :] - 2.0 * (p @ p.transpose(-1, -2)), min=0.0)
    eye = torch.eye(xy.shape[-2], dtype=torch.bool, device=xy.device)
    d2k, _ = torch.topk(d2.masked_fill(eye | ~valid[..., None, :], 1e30), k, dim=-1, largest=False, sorted=True)
    real = d2k < 1e29
    dk = torch.where(real, torch.sqrt(torch.clamp(d2k, min=0.0)) * 1e3, torch.zeros_like(d2k))
    mean = torch.where(valid, dk.sum(-1) / torch.clamp(real.sum(-1), min=1), torch.full_like(dk[..., 0], 1e30))
    vals = torch.where(valid, mean, torch.zeros_like(mean))
    mu = vals.sum(-1, keepdim=True) / denom
    var = (w * (vals - mu) ** 2).sum(-1, keepdim=True) / denom
    return mean, valid & (mean <= mu + ratio * torch.sqrt(var))


def knn_clouds(b: int, n_max: int, dev):
    """``b`` gated fleet scans on the card (`fleet_streams`, 32 scans a
    stream) with edge rows: 0 no valid point, 1 one, 2 ten (fewer than k), 3
    every valid point twice (ties), 4 stray returns."""
    import torch

    import icp_slam_yolo_tpu_torch as port
    from icp_slam_yolo_tpu_torch.ops import geometry as geo

    per = min(b, 32)
    scans, _ = fleet_streams(-(-b // per), per, n_max)
    scans = torch.from_numpy(scans.reshape(-1, n_max, 3)[:b].copy()).to(dev)
    xy, valid = geo.polar_to_cartesian(scans, port.FLEET_CONFIG.gate)
    rng = np.random.default_rng(b)
    edges = ("none", "one", "ten", "ties", "strays") if b >= 5 else ("strays",)
    for r, edge in enumerate(edges):
        idx = torch.nonzero(valid[r])[:, 0]
        if edge == "none":
            valid[r] = False
        elif edge in ("one", "ten"):
            valid[r] = False
            valid[r, idx[: 1 if edge == "one" else 10]] = True
        elif edge == "ties":
            xy[r, idx[1::2]] = xy[r, idx[: len(idx) // 2 * 2: 2]]
        else:
            far = idx[torch.from_numpy(rng.choice(len(idx), 6, replace=False)).to(dev)]
            xy[r, far] += 2500.0
    return xy.contiguous(), valid.contiguous()


def check_knn_outlier(cfg) -> tuple[dict, dict]:
    """Phase 3, continued: K9, the statistical outlier filter, against its
    plain version on the card at ``cfg``'s slots, k and std ratio, at
    B = 1, 8 and 256 (edge rows: none valid, one, ten, ties, stray returns):
    the mean k-NN distance within 1e-2 mm (and whether bit equal), masks
    equal but for points within 0.05 mm of the threshold (at most 2 a cloud),
    and k beyond the kernel's 32 refused; device us of the kernel, its bound
    (the valid pairs' operations or the bytes), the plain version and the
    filter before K9 (Gram ``bmm`` and ``torch.topk``); whether the library
    product fuses its multiply-add; then K9's launches a fleet step (1) and
    no ``torch.topk`` and no ``(B, N, N)`` tensor in the step.  Returns
    ``(K9's row, the times at each B)``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from icp_slam_yolo_tpu_torch.ops import pallas
    from icp_slam_yolo_tpu_torch.ops.pallas.knn_kernel import MAX_K, knn_outlier, knn_outlier_plain
    from icp_slam_yolo_tpu_torch.parallel import fleet as pfleet

    dev = torch.device("cuda")
    n, k, ratio = cfg.n_max, cfg.outlier_nb_neighbors, cfg.outlier_std_ratio
    row, timed = None, {}
    for b in (1, 8, 256):
        xy, valid = knn_clouds(b, n, dev)
        mean, keep = knn_outlier(xy, valid, k, ratio)
        mean_p, keep_p = knn_outlier_plain(xy, valid, k, ratio)
        torch.cuda.synchronize()
        _require(torch.equal(mean[~valid], mean_p[~valid]) and not bool(keep[~valid].any()),
                 f"K9 B={b}: invalid points not 1e30 and dropped")
        err = float((mean - mean_p)[valid].abs().max()) if bool(valid.any()) else 0.0
        bits = torch.equal(mean, mean_p)
        _require(err <= 1e-2, f"K9 B={b}: mean k-NN distance {err} mm from the plain version (tolerance 1e-2 mm)")
        vals = torch.where(valid, mean_p, torch.zeros_like(mean_p)).double()
        cnt = valid.sum(-1, keepdim=True).clamp(min=1)
        mu = vals.sum(-1, keepdim=True) / cnt
        dev_sq = torch.where(valid, vals - mu, torch.zeros_like(vals)) ** 2
        thr = mu + ratio * torch.sqrt(dev_sq.sum(-1, keepdim=True) / cnt)
        flips = keep != keep_p
        _require(bool((flips.sum(-1) <= 2).all()) and bool(((mean_p.double() - thr).abs()[flips] <= 0.05).all()),
                 f"K9 B={b}: masks differ beyond the threshold's 0.05 mm ({int(flips.sum())} points)")
        kept = int(keep.sum())
        _require(b == 1 or (not bool(keep[0].any()) and bool(keep[1].any()) and int(keep[2].sum()) > 0),
                 f"K9 B={b}: edge rows kept {keep[:5].sum(-1).tolist()}")
        ms = _device_ms(torch, lambda: knn_outlier(xy, valid, k, ratio), 100)
        plain_ms = _device_ms(torch, lambda: knn_outlier_plain(xy, valid, k, ratio), 10)
        lib_ms = _device_ms(torch, lambda: _topk_outlier(xy, valid, k, ratio), 20)
        m_v = valid.sum(-1).double()
        pairs = float((m_v * (m_v - 1)).sum())  # ordered: d^2 once an unordered pair, a compare each ordered one
        bound = _bound(7.0 * pairs / 2 + pairs, b * n * (8 + 1 + 4 + 1))
        all_pairs = _bound(4.5 * b * n * (n - 1), 0.0)[0]
        # the library product's cross term against the unfused one and the two fused ones (float64 sums)
        p = (xy - xy.mean(-2, keepdim=True)) * 1e-3
        gram = p @ p.transpose(-1, -2)
        xx = p[..., :, None, 0] * p[..., None, :, 0]
        yy = p[..., :, None, 1] * p[..., None, :, 1]
        crosses = {"unfused": xx + yy,
                   "fma(y, y, x x)": (xx.double() + p[..., :, None, 1].double() * p[..., None, :, 1].double()).float(),
                   "fma(x, x, y y)": (yy.double() + p[..., :, None, 0].double() * p[..., None, :, 0].double()).float()}
        same = ", ".join(f"{name} {float((gram == c).double().mean()):.4f}" for name, c in crosses.items())
        timed[f"knn_outlier_b{b}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound[0])
        print(f"[3] K9 knn_outlier B={b} x {n} slots, k {k}, ratio {ratio} ({int(valid.sum())} valid, {kept} kept, "
              f"{pairs / 1e6:.2f} M valid pairs): mean k-NN distance {'bit equal to' if bits else 'within'} the plain "
              f"version (max diff {err:.3g} mm, tolerance 1e-2), masks {int(flips.sum())} flips; device "
              f"{ms * 1e3:.2f} us, bound "
              f"{bound[0] * 1e3:.3f} us ({bound[1]}; all slot pairs {all_pairs * 1e3:.2f} us), plain "
              f"{plain_ms * 1e3:.1f} us, bmm + topk {lib_ms * 1e3:.1f} us; share of the library product's cross "
              f"terms equal to: {same}", flush=True)
        if b == 256:
            row = dict(name="knn_outlier", route="cuda", source="icp_slam_yolo_tpu_torch/csrc/knn.cu",
                       replaces="none (icp_slam_yolo_tpu/ops/nn.py:206 knn_mean_distance is left to XLA)",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                       library_ms=lib_ms)

    try:
        knn_outlier(xy, valid, MAX_K + 1, ratio)
        _require(False, f"K9: k {MAX_K + 1} taken on the card")
    except ValueError:
        pass

    # the fleet step: one K9 launch a step; no top-k and no (B, N, N) tensor
    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.topk, self.square = 0, []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.topk += "topk" in str(func)
            for o in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(o, torch.Tensor) and o.dim() >= 2 and tuple(o.shape[-2:]) == (n, n):
                    self.square.append(str(func))
            return out

    b, steps = 8, 5
    stack, _ = fleet_streams(b, steps + 1, n)
    scans_dev = torch.from_numpy(stack).to(dev)
    step = pfleet.make_fleet_step(cfg)
    st = pfleet.fleet_init(scans_dev[:, 0], cfg)
    torch.cuda.synchronize()
    pallas.reset_launches()
    for t in range(1, steps):
        st, _, _ = step(st, scans_dev[:, t], t - 1)
    launches = pallas.LAUNCHES["knn_outlier"]
    with Ops() as ops:
        step(st, scans_dev[:, steps], steps - 1)
    torch.cuda.synchronize()
    _require(launches == steps - 1 and pallas.LAUNCHES["knn_outlier"] == steps,
             f"K9: {launches} launches in {steps - 1} fleet steps")
    _require(ops.topk == 0 and not ops.square,
             f"K9: a fleet step calls topk {ops.topk} times, (B, N, N) from {ops.square}")
    print(f"[3] K9 on the fleet path (B={b}, preset 'fleet'): {launches} launches in {steps - 1} steps, one a step; no "
          f"topk and no (B, {n}, {n}) tensor in a step", flush=True)
    return row, timed


def fleet_streams(n_streams: int, n_scans: int, n_max: int):
    """Distinct seeded warehouse streams (own noise and dropouts, own start
    along the loop, own step length): ``(scans (B, T, n_max, 3), ground truth
    (B, T, 3))``."""
    scans, gts = [], []
    for r in range(n_streams):
        full, gt = padded_sequence(n_scans + 12 * r, 20 + r, n_max, step_mm=115.0 + 5.0 * r)
        scans.append(full[12 * r:])
        gts.append(gt[12 * r:])
    return np.stack(scans), np.stack(gts)


def depot_streams(n_streams: int, n_scans: int, n_max: int):
    """Seeded streams that leave one depot: robot ``r`` has its own seed
    (``20 + r``: noise and dropouts) and step length (``115 + 5 r`` mm), as
    in `fleet_streams`, but no start offset, so every first scan is taken at
    one pose (the shared map seeds them all at the identity).  Returns
    ``(scans (R, T, n_max, 3), ground truth (R, T, 3))``."""
    pairs = [padded_sequence(n_scans, 20 + r, n_max, step_mm=115.0 + 5.0 * r) for r in range(n_streams)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def fleet(cfg, n_scans: int = 100, n_wide: int = 30, n_cpu: int = 4) -> dict:
    """Phase 5: the fleet path on ``cfg`` (the ``fleet`` preset).  Returns the
    launch counts of the B = 8 and B = 64 runs, summed."""
    import torch

    import icp_slam_yolo_tpu_torch as port
    from icp_slam_yolo_tpu_torch.ops import pallas
    from icp_slam_yolo_tpu_torch.parallel import fleet as pfleet

    b = 8
    names = ("icp_fused", "nn_argmin", "raster_update_grid", "knn_outlier")
    stack, gts = fleet_streams(b, n_scans, cfg.n_max)
    port.fleet_run_sequence(stack[:, :4], cfg)  # warm-up
    torch.cuda.synchronize()
    pallas.reset_launches()
    t0 = time.perf_counter()
    states, outs = port.fleet_run_sequence(stack, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(pallas.LAUNCHES)
    acc, rmse, poses = (x.cpu().numpy() for x in (outs.accepted, outs.rmse, outs.pose))
    worst_pos, worst_ang = 0.0, 0.0
    for r in range(b):
        one = type(states)(*(x[r] for x in states))
        pos_err, ang_err = check_quality(f"fleet robot {r}", cfg, acc[r], rmse[r], poses[r], gts[r], one)
        worst_pos, worst_ang = max(worst_pos, pos_err.max()), max(worst_ang, ang_err.max())
    n_steps = n_scans - 1
    print(f"[5a] fleet B={b} x {n_scans} scans at full width (preset 'fleet' unchanged): "
          f"{b * n_scans / secs:.1f} robot-scans/s ({secs / n_steps * 1e3:.2f} ms per fleet step); accepted per robot "
          f"{[round(float(a.mean()), 3) for a in acc]}; median rmse {np.median(rmse[acc]):.2f} mm; trajectory error "
          f"max {worst_pos:.1f} mm, heading max {worst_ang:.4f} rad; mean ICP iterations "
          f"{outs.n_iters.float().mean():.1f}; mean gated points per scan {outs.n_points.float().mean():.1f}; "
          f"launches {launches}", flush=True)
    for name in names:
        # one launch per fleet step (K4 also once in fleet_init), not one per robot
        _require(launches[name] == n_steps + (name == "raster_update_grid"),
                 f"fleet: {name} launched {launches[name]} times in {n_steps} fleet steps")
    _require(launches["raster_update"] == 0, "fleet: the fleet step owns its grids and must take K4, not K2")

    step = pfleet.make_fleet_step(cfg)
    scans_dev = torch.from_numpy(stack[:, :6]).to("cuda")
    st = pfleet.fleet_init(scans_dev[:, 0], cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(1, 6):
            st, _, stats = step(st, scans_dev[:, t], t - 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"[5a] 5 fleet steps under torch.cuda.set_sync_debug_mode('error'): no host synchronisation "
          f"(fleet accept rate {float(stats['accept_rate']):.2f}, mean rmse {float(stats['mean_rmse']):.1f} mm)",
          flush=True)
    n_win = 21
    print(f"[5a] B={b} profiled {n_win - 1} fleet steps: "
          + profile_window(torch, lambda: port.fleet_run_sequence(stack[:, :n_win], cfg), n_win - 1), flush=True)

    # (b) 64 streams: the 8 tiled 8 times
    wide = np.tile(stack[:, :n_wide], (8, 1, 1, 1))
    port.fleet_run_sequence(wide[:, :3], cfg)
    torch.cuda.synchronize()
    pallas.reset_launches()
    t0 = time.perf_counter()
    _, outs_w = port.fleet_run_sequence(wide, cfg)
    torch.cuda.synchronize()
    secs_w = time.perf_counter() - t0
    launches_w = dict(pallas.LAUNCHES)
    _require(all(torch.equal(outs_w.pose[r], outs_w.pose[r % b]) for r in range(64)),
             "fleet B=64: lanes fed the same stream gave different poses")
    dw = float((outs_w.pose[:b] - outs.pose[:, : n_wide - 1]).abs().max())
    _require(bool((outs_w.accepted[:b] == outs.accepted[:, : n_wide - 1]).all()) and dw <= 2.0,
             f"fleet B=64 vs B=8: flags or poses differ ({dw} mm)")
    for name in names:
        _require(launches_w[name] == n_wide - 1 + (name == "raster_update_grid"),
                 f"fleet B=64: {name} launched {launches_w[name]} times in {n_wide - 1} fleet steps")
    print(f"[5b] fleet B=64 x {n_wide} scans: {64 * n_wide / secs_w:.1f} robot-scans/s "
          f"({secs_w / (n_wide - 1) * 1e3:.2f} ms per fleet step); lanes fed the same stream bit equal; against the "
          f"B=8 run max pose diff {dw:.3g} mm (tol 2 mm); launches {launches_w}", flush=True)
    print(f"[5b] B=64 profiled {n_wide - 1} fleet steps: "
          + profile_window(torch, lambda: port.fleet_run_sequence(wide, cfg), n_wide - 1), flush=True)

    # (c) robot 0 alone through the single-robot engine
    _, outs_1 = port.Slam(cfg).run(stack[0])
    d1 = (outs_1.pose - outs.pose[0]).abs().cpu().numpy()
    same = bool((outs_1.accepted == outs.accepted[0]).all())
    print(f"[5c] robot 0 alone (Slam(cfg).run, per-robot maintenance counter) vs its fleet lane: accept flags equal "
          f"{same}, max pose diff {d1[:, :2].max():.3g} mm / {d1[:, 2].max():.3g} rad (tol 2 mm / 2e-3 rad)", flush=True)
    _require(same and d1[:, :2].max() <= 2.0 and d1[:, 2].max() <= 2e-3, "fleet lane 0 and the single robot differ")

    # (d) the same fleet on the CPU (plain versions), two robots, a few scans
    t0 = time.perf_counter()
    _, outs_c = port.fleet_run_sequence(stack[:2, :n_cpu], cfg, device="cpu")
    dc = (outs_c.pose - outs.pose[:2, : n_cpu - 1].cpu()).abs().numpy()
    same = bool((outs_c.accepted == outs.accepted[:2, : n_cpu - 1].cpu()).all())
    print(f"[5d] cpu fleet replay B=2 x {n_cpu} scans ({time.perf_counter() - t0:.1f} s): accept flags equal {same}, "
          f"max pose diff {dc[..., :2].max():.3g} mm / {dc[..., 2].max():.3g} rad (tol 2 mm / 2e-3 rad)", flush=True)
    _require(same and dc[..., :2].max() <= 2.0 and dc[..., 2].max() <= 2e-3, "cpu and card fleets differ")
    return {k: launches[k] + launches_w[k] for k in launches}


SHARED_CPU_STEPS = 8  # steps of the R = 8 shared run replayed on the CPU


def interleave_stream(n_scans: int, n_max: int):
    """One seeded stream for two robots to share (even and odd scans): 75
    mm a scan, so each robot moves 150 mm a step, and its first two scans
    taken at the start pose (the robot at rest, as the reference's
    recordings start), since the shared map seeds both first scans at the
    identity.  Returns ``(scans (n, n_max, 3), ground truth (n, 3))``."""
    first, g0 = padded_sequence(1, 1, n_max, step_mm=75.0)
    rest, gt = padded_sequence(n_scans - 1, 0, n_max, step_mm=75.0)
    return np.concatenate([first, rest]), np.concatenate([g0, gt])


def shared_path(cfg, n_scans: int = 100, n_wide: int = 20, n_inter: int = 120) -> dict:
    """Phase 14: the shared-map fleet (`parallel/shared.shared_fleet_run`) on
    ``cfg`` (the ``fleet`` preset unchanged): 8 robots leaving one depot
    (`depot_streams`) x ``n_scans`` scans, then 64 (the 8 tiled 8 times) x
    ``n_wide``, each between a reset and a reading of the launch counters
    (K1, K3, K4 and K9 once a step; K4 once more for the seed); every robot's
    trajectory through `check_quality`; five steps under the sync debug
    mode; a profiler window over each run; the first ``SHARED_CPU_STEPS``
    steps of the R = 8 run on the CPU (plain versions) against the card; a
    2-robot interleave of one stream (`interleave_stream`) on the
    ``realtime`` preset (4096 map slots, no reseed, as JAX's real-data test)
    against the single-robot ``Slam`` on the whole stream.  Returns the
    launches of the two fleet runs, summed."""
    import types

    import torch

    import icp_slam_yolo_tpu_torch as port
    from icp_slam_yolo_tpu_torch.ops import pallas
    from icp_slam_yolo_tpu_torch.parallel import shared as pshared

    names = ("icp_fused", "nn_argmin", "raster_update_grid", "knn_outlier")

    def run(stack, what):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pallas.reset_launches()
        t0 = time.perf_counter()
        out = pshared.shared_fleet_run(stack, cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(pallas.LAUNCHES)
        n_steps = stack.shape[1] - 1
        for name in names:
            _require(launches[name] == n_steps + (name == "raster_update_grid"),
                     f"{what}: {name} launched {launches[name]} times in {n_steps} steps")
        _require(launches["raster_update"] == 0, f"{what}: the robots' grid copies are updated in place (K4), not K2")
        return out, secs, launches, torch.cuda.max_memory_allocated() / 2**30

    def quality(what, out, gts):
        map_xy, map_valid, occ, _, outs = out
        acc, rmse, poses = (x.cpu().numpy() for x in (outs.accepted, outs.rmse, outs.pose))
        shared_map = types.SimpleNamespace(map_valid=map_valid, occ=occ)
        worst = [0.0, 0.0]
        for r in range(acc.shape[0]):
            pos_err, ang_err = check_quality(f"{what} robot {r}", cfg, acc[r], rmse[r], poses[r], gts[r], shared_map)
            worst = [max(worst[0], pos_err.max()), max(worst[1], ang_err.max())]
        return (f"accepted {acc.mean():.4f} (least robot {acc.mean(1).min():.3f}), median rmse "
                f"{np.median(rmse[acc]):.2f} mm, trajectory error max {worst[0]:.1f} mm, heading max {worst[1]:.4f} rad, "
                f"shared map {int(map_valid.sum())} of {cfg.map_capacity} points, grid cells painted "
                f"{int((occ != 0.5).sum())}")

    b = 8
    stack, gts = depot_streams(b, n_scans, cfg.n_max)
    pshared.shared_fleet_run(stack[:, :4], cfg)  # warm-up
    out, secs, launches, peak = run(stack, "shared R=8")
    print(f"[14a] shared map, R={b} depot robots x {n_scans} scans (preset 'fleet' unchanged: map {cfg.map_capacity}, "
          f"grid {cfg.map.height_px}x{cfg.map.width_px}): {b * n_scans / secs:.1f} robot-scans/s "
          f"({secs / (n_scans - 1) * 1e3:.2f} ms a step); peak memory {peak:.3f} GiB; {quality('shared R=8', out, gts)}; "
          f"launches {launches}", flush=True)

    step = pshared.make_shared_step(cfg)
    scans_dev = torch.from_numpy(stack[:, :6]).to("cuda")
    st = pshared.shared_init(scans_dev[:, 0], cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(1, 6):
            st, _ = step(st, scans_dev[:, t], t - 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("[14a] 5 shared steps under torch.cuda.set_sync_debug_mode('error'): no host synchronisation", flush=True)
    n_win = 21
    print(f"[14a] R={b} profiled {n_win - 1} shared steps: "
          + profile_window(torch, lambda: pshared.shared_fleet_run(stack[:, :n_win], cfg), n_win - 1), flush=True)

    # (b) 64 robots: the 8 depot streams tiled 8 times
    wide = np.tile(stack[:, :n_wide], (8, 1, 1, 1))
    pshared.shared_fleet_run(wide[:, :3], cfg)
    out_w, secs_w, launches_w, peak_w = run(wide, "shared R=64")
    pose_w = out_w[4].pose
    _require(all(torch.equal(pose_w[r], pose_w[r % b]) for r in range(64)),
             "shared R=64: robots fed the same stream gave different poses")
    print(f"[14b] shared map, R=64 x {n_wide} scans: {64 * n_wide / secs_w:.1f} robot-scans/s "
          f"({secs_w / (n_wide - 1) * 1e3:.2f} ms a step); peak memory {peak_w:.3f} GiB; robots fed the same stream bit "
          f"equal; {quality('shared R=64', out_w, np.tile(gts[:, :n_wide], (8, 1, 1)))}; launches {launches_w}", flush=True)
    print(f"[14b] R=64 profiled {n_wide - 1} shared steps: "
          + profile_window(torch, lambda: pshared.shared_fleet_run(wide, cfg), n_wide - 1), flush=True)

    # (c) the first steps on the CPU (on a longer replay rounding leads some
    # registration to a neighbouring fixed point of ICP and the runs part by
    # millimetres, as JAX's own Pallas and XLA paths do, see
    # `tests/test_torch_shared.py`; this holds while the card and the CPU
    # end in the same fixed points)
    t0 = time.perf_counter()
    _, _, _, _, outs_c = pshared.shared_fleet_run(stack[:, :SHARED_CPU_STEPS + 1], cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    card = out[4]
    same = bool((outs_c.accepted == card.accepted[:, :SHARED_CPU_STEPS].cpu()).all())
    d = (outs_c.pose - card.pose[:, :SHARED_CPU_STEPS].cpu()).abs().numpy()
    print(f"[14c] cpu shared run R={b} x {SHARED_CPU_STEPS} steps ({cpu_s:.1f} s): accept flags equal {same}; max pose "
          f"diff {d[..., :2].max():.3g} mm / {d[..., 2].max():.3g} rad (tol 0.5 mm / 2e-4 rad)", flush=True)
    _require(same and d[..., :2].max() <= 0.5 and d[..., 2].max() <= 2e-4, "cpu and card shared runs differ")

    # (d) two robots, one stream's even and odd scans, against the single robot
    icfg = port.REALTIME_CONFIG.replace(map_capacity=4096, local_map_capacity=4096, reseed_after_rejects=0)
    scans, _ = interleave_stream(n_inter, cfg.n_max)
    t = n_inter // 2
    pair = np.stack([scans[0::2][:t], scans[1::2][:t]])
    _, i_valid, i_occ, _, i_outs = pshared.shared_fleet_run(pair, icfg)
    _, s_outs = port.Slam(icfg).run(scans)
    acc = i_outs.accepted.cpu().numpy()
    n_live = int(i_valid.sum())
    o = i_occ.cpu().numpy()
    seq, both = s_outs.pose.cpu().numpy(), i_outs.pose.cpu().numpy()
    # robot A's k-th processed scan is scan 2k + 2 of the stream (sequential row 2k + 1); robot B's 2k + 3
    worst = max(float(np.hypot(*(both[r, k, :2] - seq[2 * k + 1 + r, :2])))
                for r in (0, 1) for k in range(t - 1) if 2 * k + 1 + r < len(seq))
    print(f"[14d] 2-robot interleave of {n_inter} scans (75 mm a scan, at rest for the first two) on 'realtime' "
          f"(4096 slots, no reseed): accepted "
          f"{acc.mean():.4f} (after 5 steps {acc[:, 5:].mean():.4f}, tolerance > 0.85), shared map {n_live} points, grid "
          f"[{o.min():.3g}, {o.max():.3g}]; largest distance of a robot's pose from the single robot's on the whole stream "
          f"{worst:.1f} mm (tolerance 300 mm)", flush=True)
    _require(acc[:, 5:].mean() > 0.85 and 500 < n_live <= icfg.map_capacity, "interleave: tracking or map count")
    _require(o.min() > 0.0 and o.max() <= 1.0 and (o < 0.3).any() and (o > 0.6).any(), "interleave: grid")
    _require(worst < 300.0, f"interleave: {worst:.1f} mm from the single robot")
    return {k: launches[k] + launches_w[k] for k in launches}


# ---------------------------------------------------------------- phase 15: several processes

DIST_TRAIN_STEPS = 20  # the recipe's data-parallel steps on the one-rank group (15a)
DIST_SHARED = (8, 20)  # 15b's shared map: robots, scans
DIST_FLEET = (8, 30)   # 15b's fleet: robots, scans
DIST_TIMEOUT_S = 300.0  # the two ranks of 15b answer within this or are killed
TRAIN_FLOOR = (2.0 ** -7, 0.05)  # the least bf16 tolerance of a step: its loss's relative gap, its update's


def _equal_runs(a, b) -> bool:
    """Two runs' tensors (nested tuples, NamedTuples) bit-equal."""
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(_equal_runs(x, y) for x, y in zip(a, b))


def _digest(*tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _train_batches(root: str, n: int, device=None) -> list:
    """``n`` batches of the recipe (640 px, 16 images, zoom-out and flips)
    from the dataset's seeded draws: the same on every process."""
    from icp_slam_yolo_tpu_torch.io.yolo_data import DeviceYoloDataset

    ds = DeviceYoloDataset(root, img_size=640, batch_size=16, max_gt=16, augment=True, seed=15,
                           scale_aug=(0.5, 0.67, 0.83, 1.0), device=device)
    it = iter(ds)
    return [{k: v.clone() for k, v in next(it).items()} for _ in range(n)]


class _Recipe:
    """The recipe's model (yolo-n v8, seed 0, ``dtype`` compute, float32
    parameters) and its ``make_train_step`` (with a ``mesh``: each step on
    this rank's block of the batch), for ``total_steps`` steps' schedule.
    `snapshot` and `load` carry the parameters, statistics and optimizer
    state from one recipe to another, so that two steps start alike."""

    def __init__(self, total_steps: int, dtype: str = "bfloat16", mesh=None, device=None):
        import torch

        from icp_slam_yolo_tpu_torch.models.train import create_train_state, make_train_step
        from icp_slam_yolo_tpu_torch.models.yolo import YOLO

        self.model = YOLO(num_classes=1, compute_dtype=getattr(torch, dtype))
        self.state = create_train_state(self.model, 640, total_steps=total_steps, device=device)
        self.fn = make_train_step(self.model, self.state.optimizer, 640, mesh=mesh)
        self.mesh = mesh

    def params(self):
        import torch

        return torch.cat([p.detach().reshape(-1) for p in self.model.parameters()])

    def snapshot(self) -> dict:
        import copy

        opt = self.state.optimizer
        return {"model": {k: v.detach().clone() for k, v in self.model.state_dict().items()},
                "sgd": copy.deepcopy(opt.sgd.state_dict()), "count": opt.count}

    def load(self, snap: dict) -> None:
        opt = self.state.optimizer
        self.model.load_state_dict(snap["model"])
        opt.sgd.load_state_dict(snap["sgd"])
        opt.count = snap["count"]

    def step(self, batch: dict):
        """One step on ``batch``: its metrics (floats) and synchronised wall (ms)."""
        import torch

        from icp_slam_yolo_tpu_torch.parallel.mesh import rank_block

        if self.mesh is not None:
            rows = rank_block(batch["images"].shape[0], self.mesh)
            batch = {k: v[rows] for k, v in batch.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.state, m = self.fn(self.state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return {k: float(v) for k, v in m.items()}, ms


def _step_gap(loss: float, update, loss_ref: float, update_ref) -> tuple[float, float]:
    """How far a step is from a reference step taken from the same state on
    the same batch: its loss's relative gap, and its update's distance from
    the reference's over the reference's norm."""
    return abs(loss - loss_ref) / abs(loss_ref), float((update - update_ref).norm() / update_ref.norm())


def _within_bf16(what: str, gaps: list, scales: list) -> str:
    """Each step's `_step_gap` within bf16 rounding: no further from the
    bf16 step without a mesh than the float32 step from the same state is
    (``scales``), or than ``TRAIN_FLOOR``."""
    for i, (gap, scale) in enumerate(zip(gaps, scales)):
        tol = [max(s, f) for s, f in zip(scale, TRAIN_FLOOR)]
        _require(gap[0] <= tol[0] and gap[1] <= tol[1], f"{what}, step {i + 1}: loss apart {gap[0]:.4g} (tol "
                 f"{tol[0]:.4g}) or update apart {gap[1]:.4g} (tol {tol[1]:.4g})")
    worst = [max(g[k] for g in gaps) for k in (0, 1)]
    scale = [max(g[k] for g in scales) for k in (0, 1)]
    return (f"each step from the same state as the bf16 step without a mesh: loss apart at most {worst[0]:.3g} "
            f"relative, update apart at most {worst[1]:.3g} of its norm (tolerance a step: the float32 step's "
            f"distance from the bf16 one, at most {scale[0]:.3g} and {scale[1]:.3g}, and at least "
            f"{TRAIN_FLOOR[0]:.3g} and {TRAIN_FLOOR[1]:.3g})")


def _dist_rank(rank: int, store: str, root: str, batch_digest: str, results) -> None:
    """One of 15b's two ranks (spawned): a gloo group whose ranks share
    card 0; the shared map, the fleet and two data-parallel steps over a
    mesh of both (the dataset and the reference's state under ``root``).
    Puts ``(rank, ok, result or traceback)`` on ``results``."""
    import traceback

    import torch

    try:
        results.put((rank, True, _dist_rank_work(rank, store, root, batch_digest)))
    except Exception:  # reported to the parent, which fails the phase
        results.put((rank, False, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _dist_rank_work(rank: int, store: str, root: str, batch_digest: str) -> dict:
    import os

    import torch
    import torch.distributed as dist

    import icp_slam_yolo_tpu_torch as port
    from icp_slam_yolo_tpu_torch.ops import pallas
    from icp_slam_yolo_tpu_torch.parallel import distributed, mesh as pmesh, shared as pshared

    dev = distributed.initialize(store, 2, rank, backend="gloo", device="cuda:0")
    mesh = pmesh.make_mesh(device_type="cuda")
    cfg = port.FLEET_CONFIG
    spent = {"s": 0.0, "calls": 0}

    def timed(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent["s"] += time.perf_counter() - t0
            spent["calls"] += 1
            return out
        return call

    dist.all_reduce, dist.all_gather_into_tensor = timed(dist.all_reduce), timed(dist.all_gather_into_tensor)
    out = {"device": str(dev), "backend": dist.get_backend()}

    # the shared map: the entry point timed, then its step loop with a digest of the replicated state a step
    r, n = DIST_SHARED
    stack, _ = depot_streams(r, n, cfg.n_max)
    pshared.shared_fleet_run(stack[:, :3], cfg, mesh=mesh)  # warm-up
    torch.cuda.synchronize()
    pallas.reset_launches()
    spent.update(s=0.0, calls=0)
    t0 = time.perf_counter()
    run = pshared.shared_fleet_run(stack, cfg, mesh=mesh)
    torch.cuda.synchronize()
    out["shared_s"], out["shared_coll"] = time.perf_counter() - t0, dict(spent)
    out["shared_launches"] = dict(pallas.LAUNCHES)
    block = torch.from_numpy(stack[pmesh.rank_block(r, mesh)]).to(dev)
    step = pshared.make_shared_step(cfg, mesh)
    state = pshared.shared_init(block[:, 0], cfg, mesh)
    digests, outs = [_digest(state.map_xy, state.map_valid, state.occ)], []
    for t in range(1, n):
        state, o = step(state, block[:, t], t - 1)
        digests.append(_digest(state.map_xy, state.map_valid, state.occ))
        outs.append(o)
    pose, rmse, acc = (torch.stack(f, dim=1) for f in zip(*outs))
    out["shared_loop_same"] = _equal_runs((state.map_xy, state.map_valid, state.occ, state.pose, pose, rmse, acc),
                                          (*run[:4], *run[4]))
    out["shared_digests"] = digests
    out["shared"] = {k: v.cpu().numpy() for k, v in zip(("map_xy", "map_valid", "occ", "poses"), run[:4])}
    out["shared"].update({k: v.cpu().numpy() for k, v in run[4]._asdict().items()})

    # the fleet, sharded
    b, n = DIST_FLEET
    fstack, _ = fleet_streams(b, n, cfg.n_max)
    port.fleet_run_sharded(fstack[:, :3], cfg, mesh=mesh)  # warm-up
    torch.cuda.synchronize()
    pallas.reset_launches()
    t0 = time.perf_counter()
    _, fouts = port.fleet_run_sharded(fstack, cfg, mesh=mesh)
    torch.cuda.synchronize()
    out["fleet_s"], out["fleet_launches"] = time.perf_counter() - t0, dict(pallas.LAUNCHES)
    out["fleet"] = {k: v.cpu().numpy() for k, v in fouts._asdict().items()}

    # two data-parallel steps, each rank on 8 of the 16: the first from the seed's state, the second from the
    # reference's state after its first step (`snap1.pt`), as the parent took them
    batches = _train_batches(os.path.join(root, "pallets", "train"), 2, device=dev)
    _require(_digest(*(t for bt in batches for t in bt.values())) == batch_digest, "rank: other batches than the parent's")
    dp = _Recipe(2, mesh=mesh, device=dev)
    spent.update(s=0.0, calls=0)
    m1, t1 = dp.step(batches[0])
    p1 = dp.params()
    dp.load(torch.load(os.path.join(root, "snap1.pt"), map_location=dev))
    m2, t2 = dp.step(batches[1])
    p2 = dp.params()
    out["train"] = {"metrics": [m1, m2], "ms": [t1, t2], "coll": dict(spent),
                    "params": [p1.cpu().numpy(), p2.cpu().numpy()], "digest": _digest(p1, p2)}
    return out


def dist_path(cfg) -> dict:
    """Phase 15: the fleet, the shared map and the train step across
    processes on ``torch.distributed``.  (a) One rank, NCCL, in this process
    on card 0 (a FileStore in a temporary directory): `fleet_run_sharded` on
    ``cfg`` (the ``fleet`` preset unchanged) at 8 x 100, bit-equal to
    `fleet_run_sequence`; the shared map over the group, R = 8 x 100,
    bit-equal to the one-card `shared_fleet_run`; five fleet and five shared
    steps over the group under the sync debug mode; a profiler window over
    each, the NCCL kernels listed apart; the recipe's data-parallel step
    (yolo-n v8, 640 px, batch 16, bf16 compute) for ``DIST_TRAIN_STEPS``
    steps against the step without a mesh on the same batches, within bf16
    rounding (`_within_bf16`; each step from the state of the run without a
    mesh), and three profiled steps.  (b) Two spawned ranks sharing the card
    over gloo: the shared map at ``DIST_SHARED``, the fleet at
    ``DIST_FLEET``, two data-parallel steps of 2 x 8 against 1 x 16 (each
    from the reference's state); the replicated map and grid
    bit-identical across the ranks at every step; each rank's K1, K3 and K4
    counters above 0.  Returns the launches of (a)'s runs over the group
    and of (b)'s ranks, summed."""
    import multiprocessing
    import os
    import queue
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    import icp_slam_yolo_tpu_torch as port
    from icp_slam_yolo_tpu_torch.ops import pallas
    from icp_slam_yolo_tpu_torch.parallel import distributed, fleet as pfleet, mesh as pmesh, shared as pshared

    t_phase = time.perf_counter()
    names = ("icp_fused", "nn_argmin", "raster_update_grid", "knn_outlier")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    totals = dict.fromkeys(pallas.LAUNCHES, 0)

    def counted(fn, steps, what):
        torch.cuda.synchronize()
        pallas.reset_launches()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(pallas.LAUNCHES)
        for name in names:
            _require(launches[name] == steps + (name == "raster_update_grid"),
                     f"{what}: {name} launched {launches[name]} times in {steps} steps")
        return got, secs, launches

    def timed_one_card(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    # ---- (a) one rank, NCCL
    dev = distributed.initialize(f"file://{tmp}/store_nccl", 1, 0)
    _require(dev == torch.device("cuda", 0) and dist.get_backend() == "nccl", f"15a: {dev} {dist.get_backend()}")
    try:
        mesh = pmesh.make_mesh()
        b, n = 8, 100
        stack, _ = fleet_streams(b, n, cfg.n_max)
        port.fleet_run_sharded(stack[:, :4], cfg, mesh=mesh)  # warm-up
        one, one_s = timed_one_card(lambda: port.fleet_run_sequence(stack, cfg))
        got, secs, launches = counted(lambda: port.fleet_run_sharded(stack, cfg, mesh=mesh), n - 1, "15a fleet")
        _require(_equal_runs(got, one), "15a: fleet_run_sharded on one rank differs from fleet_run_sequence")
        totals = {k: totals[k] + launches[k] for k in totals}
        print(f"[15a] fleet_run_sharded over a one-rank NCCL group on {dev} (preset 'fleet' unchanged), {b} x {n} "
              f"scans: {b * n / secs:.1f} robot-scans/s ({secs / (n - 1) * 1e3:.2f} ms a step; fleet_run_sequence in "
              f"this phase {b * n / one_s:.1f}); outputs and states bit-equal to fleet_run_sequence; launches "
              f"{ {k: launches[k] for k in names} }", flush=True)

        step, plain = pfleet.make_fleet_step(cfg, mesh), pfleet.make_fleet_step(cfg)
        scans_dev = torch.from_numpy(stack[:, :7]).to(dev)
        st, st1 = pfleet.fleet_init(scans_dev[:, 0], cfg), pfleet.fleet_init(scans_dev[:, 0], cfg)
        st, _, stats = step(st, scans_dev[:, 1], 0)  # the first collective sets up NCCL's communicator
        st1, _, stats1 = plain(st1, scans_dev[:, 1], 0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(2, 7):
                st, _, stats = step(st, scans_dev[:, t], t - 1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for t in range(2, 7):
            st1, _, stats1 = plain(st1, scans_dev[:, t], t - 1)
        same = all(torch.equal(stats[k], stats1[k]) for k in stats)
        _require(same, f"15a: the fleet statistics over the group {stats} differ from one card's {stats1}")
        print(f"[15a] 5 fleet steps over the group (statistics all-reduced by NCCL) under "
              f"torch.cuda.set_sync_debug_mode('error'): no host synchronisation; statistics bit-equal to one card's "
              f"(accept rate {float(stats['accept_rate']):.2f}, mean rmse {float(stats['mean_rmse']):.2f} mm)", flush=True)

        def fleet_steps(k):
            s = pfleet.fleet_init(scans_dev[:, 0], cfg)
            for t in range(1, k + 1):
                s = step(s, scans_dev[:, t], t - 1)[0]

        print("[15a] 6 fleet steps over the group profiled (the init's K4 in the window): "
              + profile_window(torch, lambda: fleet_steps(6), 6, apart="nccl"), flush=True)

        # the shared map over the group
        stack, _ = depot_streams(b, n, cfg.n_max)
        pshared.shared_fleet_run(stack[:, :4], cfg, mesh=mesh)  # warm-up
        one, one_s = timed_one_card(lambda: pshared.shared_fleet_run(stack, cfg))
        got, secs, launches = counted(lambda: pshared.shared_fleet_run(stack, cfg, mesh=mesh), n - 1, "15a shared")
        _require(_equal_runs(got, one), "15a: the shared map over one rank differs from the one-card shared_fleet_run")
        totals = {k: totals[k] + launches[k] for k in totals}
        print(f"[15a] shared map over the one-rank NCCL group, R={b} x {n} scans: {b * n / secs:.1f} robot-scans/s "
              f"({secs / (n - 1) * 1e3:.2f} ms a step; the one-card shared_fleet_run in this phase "
              f"{b * n / one_s:.1f}); map, grid, poses and outputs bit-equal to the one-card run; launches "
              f"{ {k: launches[k] for k in names} }", flush=True)
        sstep = pshared.make_shared_step(cfg, mesh)
        scans_dev = torch.from_numpy(stack[:, :7]).to(dev)
        ss = sstep(pshared.shared_init(scans_dev[:, 0], cfg, mesh), scans_dev[:, 1], 0)[0]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(2, 7):
                ss = sstep(ss, scans_dev[:, t], t - 1)[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print("[15a] 5 shared steps over the group (the merge and the candidates through NCCL) under "
              "torch.cuda.set_sync_debug_mode('error'): no host synchronisation", flush=True)

        def shared_steps(k):
            s = pshared.shared_init(scans_dev[:, 0], cfg, mesh)
            for t in range(1, k + 1):
                s = sstep(s, scans_dev[:, t], t - 1)[0]

        print("[15a] 6 shared steps over the group profiled (the seed's merge in the window): "
              + profile_window(torch, lambda: shared_steps(6), 6, apart="nccl"), flush=True)

        # the recipe's data-parallel step against PR 9's step, the same batches
        root = pallet_dataset(os.path.join(tmp, "pallets"), seed=12, n_train=16, n_val=1)
        batches = _train_batches(os.path.join(root, "train"), DIST_TRAIN_STEPS)
        plain, dp = _Recipe(DIST_TRAIN_STEPS), _Recipe(DIST_TRAIN_STEPS, mesh=mesh)
        full = _Recipe(DIST_TRAIN_STEPS, dtype="float32")
        gaps, scales, ms, ms_plain, losses = [], [], [], [], []
        for batch in batches:  # every step of the three from the plain run's state
            snap, p0 = plain.snapshot(), plain.params()
            m_plain, t_plain = plain.step(batch)
            dp.load(snap)
            m_dp, t_dp = dp.step(batch)
            full.load(snap)
            m_full, _ = full.step(batch)
            ref = plain.params() - p0
            gaps.append(_step_gap(m_dp["loss"], dp.params() - p0, m_plain["loss"], ref))
            scales.append(_step_gap(m_full["loss"], full.params() - p0, m_plain["loss"], ref))
            ms.append(t_dp)
            ms_plain.append(t_plain)
            losses.append(m_plain["loss"])
        agree = _within_bf16("15a train", gaps, scales)
        med, med1 = float(np.median(ms[1:])), float(np.median(ms_plain[1:]))
        print(f"[15a] the recipe's data-parallel step over the one-rank group (yolo-n v8, 640 px, batch 16, bf16 "
              f"compute), {DIST_TRAIN_STEPS} steps against make_train_step without a mesh on the same batches, "
              f"{agree}; step wall median {med:.2f} ms ({16e3 / med:.1f} images/s), without a mesh {med1:.2f} ms; "
              f"losses {[round(v, 3) for v in losses[::5]]} (steps 1, 6, 11, 16)", flush=True)
        window = batches[:3]
        print("[15a] 3 data-parallel steps profiled: " + profile_window(
            torch, lambda: [dp.step(bt) for bt in window], 3, apart="nccl"), flush=True)
    finally:
        dist.destroy_process_group()

    # ---- (b) two ranks sharing the card over gloo
    # the two steps of 1 x 16 (the reference), and in float32 from the same states (the scale)
    batch_digest = _digest(*(t for bt in batches[:2] for t in bt.values()))
    ref, full = _Recipe(2), _Recipe(2, dtype="float32")
    snaps, ref_steps, scales = [], [], []
    for batch in batches[:2]:
        snaps.append(ref.snapshot())
        p0 = ref.params()
        m_ref, t_ref = ref.step(batch)
        full.load(snaps[-1])
        m_full, _ = full.step(batch)
        ref_steps.append((m_ref, t_ref, p0, ref.params() - p0))
        scales.append(_step_gap(m_full["loss"], full.params() - p0, m_ref["loss"], ref.params() - p0))
    torch.save(snaps[1], os.path.join(tmp, "snap1.pt"))
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_dist_rank, args=(r, f"file://{tmp}/store_gloo", tmp, batch_digest, results))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got, failed = {}, {}
    try:
        while len(got) + len(failed) < 2:
            rank, ok, value = results.get(timeout=max(DIST_TIMEOUT_S - (time.perf_counter() - t0), 1.0))
            (got if ok else failed)[rank] = value
    except queue.Empty:
        failed["timeout"] = f"the ranks did not answer within {DIST_TIMEOUT_S} s"
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    _require(not failed, "15b: " + "\n".join(f"rank {k}: {v}" for k, v in failed.items()))
    ranks_s = time.perf_counter() - t0
    r0, r1 = got[0], got[1]
    for r in (r0, r1):
        _require(r["backend"] == "gloo" and r["device"] == "cuda:0", f"15b: {r['backend']} on {r['device']}")
        for key in ("shared_launches", "fleet_launches"):
            _require(all(r[key][k] > 0 for k in names), f"15b: a rank's {key} {r[key]}")
        _require(r["shared_loop_same"], "15b: shared_fleet_run(mesh=...) differs from its step loop")
    _require(r0["shared_digests"] == r1["shared_digests"], "15b: the ranks' maps or grids differ at some step")
    for k in ("map_xy", "map_valid", "occ"):
        _require(np.array_equal(r0["shared"][k], r1["shared"][k]), f"15b: the ranks' {k} differ")

    # the gathered runs against one rank (the shared map: test_torch_shared's tolerances; the fleet: bit-equal)
    r, n = DIST_SHARED
    one = pshared.shared_fleet_run(depot_streams(r, n, cfg.n_max)[0], cfg)
    gathered = {k: np.concatenate([r0["shared"][k], r1["shared"][k]]) for k in ("pose", "rmse", "accepted")}
    _require(np.array_equal(gathered["accepted"], one[4].accepted.cpu().numpy()), "15b: accept flags differ")
    d = np.abs(gathered["pose"] - one[4].pose.cpu().numpy())
    cells = float((np.abs(r0["shared"]["occ"] - one[2].cpu().numpy()) <= 1e-4).mean())
    _require(d[..., :2].max() <= 0.5 and d[..., 2].max() <= 2e-4 and cells >= 0.999,
             f"15b: shared map against one rank: {d[..., :2].max()} mm, {d[..., 2].max()} rad, grid {cells}")
    # the fleet: each rank steps 4 robots, one rank 8, and on the card some reductions of the batched step
    # (their launch shapes) follow the batch, so the lanes agree as phase 5's B = 64 and B = 8 runs do
    b, n = DIST_FLEET
    _, fone = port.fleet_run_sequence(fleet_streams(b, n, cfg.n_max)[0], cfg)
    fleet = {k: np.concatenate([r0["fleet"][k], r1["fleet"][k]]) for k in ("accepted", "pose", "n_points")}
    _require(np.array_equal(fleet["accepted"], fone.accepted.cpu().numpy())
             and np.array_equal(fleet["n_points"], fone.n_points.cpu().numpy()), "15b: the fleet's flags or counts differ")
    df = np.abs(fleet["pose"] - fone.pose.cpu().numpy())
    _require(df[..., :2].max() <= 2.0 and df[..., 2].max() <= 2e-3,
             f"15b: the fleet's poses {df[..., :2].max()} mm / {df[..., 2].max()} rad from one rank's")
    _require(r0["train"]["digest"] == r1["train"]["digest"], "15b: the ranks' parameters differ after the steps")
    rt = r0["train"]
    gaps = []
    for (m_ref, _, p0, update), m, p in zip(ref_steps, rt["metrics"], rt["params"]):
        gaps.append(_step_gap(m["loss"], torch.from_numpy(p).to(p0.device) - p0, m_ref["loss"], update))
    agree = _within_bf16("15b train", gaps, scales)
    for r in (r0, r1):
        totals = {k: totals[k] + r["shared_launches"][k] + r["fleet_launches"][k] for k in totals}
    ms_shared = max(r0["shared_s"], r1["shared_s"]) / (DIST_SHARED[1] - 1) * 1e3
    ms_fleet = max(r0["fleet_s"], r1["fleet_s"]) / (DIST_FLEET[1] - 1) * 1e3
    print(f"[15b] two ranks on one card over gloo: not a scaling number. Shared map R={DIST_SHARED[0]} ({DIST_SHARED[0] // 2} a rank) x "
          f"{DIST_SHARED[1]} scans: {DIST_SHARED[0] * DIST_SHARED[1] / max(r0['shared_s'], r1['shared_s']):.1f} "
          f"robot-scans/s ({ms_shared:.2f} ms a step), in gloo collectives (host) {r0['shared_coll']['s'] * 1e3:.1f} / "
          f"{r1['shared_coll']['s'] * 1e3:.1f} ms over {r0['shared_coll']['calls']} calls a rank; map and grid "
          f"bit-identical across the ranks at every step (digests) and at the end; against one rank: flags equal, "
          f"poses within {d[..., :2].max():.3g} mm / {d[..., 2].max():.3g} rad (tol 0.5 mm / 2e-4 rad), grid cells "
          f"within 1e-4 {cells:.5f} (tol 0.999)", flush=True)
    print(f"[15b] two ranks on one card over gloo: not a scaling number. Fleet {DIST_FLEET[0]} x {DIST_FLEET[1]}: "
          f"{DIST_FLEET[0] * DIST_FLEET[1] / max(r0['fleet_s'], r1['fleet_s']):.1f} robot-scans/s ({ms_fleet:.2f} ms "
          f"a step); against one rank (8 robots a step): flags and gated counts equal, poses within "
          f"{df[..., :2].max():.3g} mm / {df[..., 2].max():.3g} rad (tol 2 mm / 2e-3 rad, phase 5's); launches rank 0 "
          f"{ {k: r0['shared_launches'][k] + r0['fleet_launches'][k] for k in names} }, rank 1 "
          f"{ {k: r1['shared_launches'][k] + r1['fleet_launches'][k] for k in names} }", flush=True)
    print(f"[15b] two ranks on one card over gloo: not a scaling number. Two data-parallel steps of 2 x 8 against "
          f"1 x 16: {agree}; parameters bit-identical across the ranks; step wall {rt['ms'][0]:.1f} / "
          f"{rt['ms'][1]:.1f} ms (1 x 16: {ref_steps[0][1]:.1f} / {ref_steps[1][1]:.1f}), in gloo collectives (host) "
          f"{rt['coll']['s'] * 1e3:.1f} ms over {rt['coll']['calls']} calls; the ranks' wall {ranks_s:.1f} s",
          flush=True)
    print("[15] NCCL across cards was not run: this machine has one card, and NCCL refuses two ranks on one GPU",
          flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[15] phase 15 in {time.perf_counter() - t_phase:.1f} s; launches {totals}", flush=True)
    return totals


def paused_sequence(n_before: int, n_garbage: int, n_hold: int, n_after: int, seed: int, n_max: int):
    """A replay in which the robot stops at scan ``n_before - 1``: there it
    sees ``n_garbage`` garbage scans (a sensor fault), then ``n_hold`` good
    scans from the same spot, then moves on for ``n_after`` scans.  Returns
    ``(scans, ground truth, forced)``; ``forced`` marks the garbage scans."""
    padded, gt = padded_sequence(n_before + n_after, seed, n_max)
    at = n_before - 1
    held = np.repeat(padded[at: at + 1], n_garbage + n_hold, axis=0)
    held[:n_garbage] = garbage_like(held[:n_garbage], seed)
    scans = np.concatenate([padded[:n_before], held, padded[n_before:]])
    truth = np.concatenate([gt[:n_before], np.repeat(gt[at: at + 1], n_garbage + n_hold, axis=0), gt[n_before:]])
    forced = np.zeros(len(scans), bool)
    forced[n_before: n_before + n_garbage] = True
    return scans, truth, forced


def presets(offline_cfg, realtime_cfg) -> dict:
    """Phase 6: the ``offline`` and ``realtime`` presets unchanged, on
    sequences with garbage scans; the rescue runs on every scan its first
    pass rejects, and under ``realtime`` twelve garbage scans in a row
    trigger the reseed.  The rescue's runs are counted from K3's launches:
    each run makes ``max_iterations + 1`` of them.  Each preset's steps on
    the good scans before the garbage are profiled too (device time, launches
    and busy share a step).  Then ``gicp()`` on one pair, card against CPU.
    Returns the launch counts, summed (over the checked runs)."""
    import torch

    import icp_slam_yolo_tpu_torch as port
    from icp_slam_yolo_tpu_torch.ops import pallas

    total = dict.fromkeys(pallas.LAUNCHES, 0)
    # offline: two garbage scans; offline semantics skip a rejected scan whole
    cfg = offline_cfg
    scans, gt, forced = paused_sequence(20, 2, 1, 20, 31, cfg.n_max)
    pallas.reset_launches()
    t0 = time.perf_counter()
    slam = port.Slam(cfg)
    state, outs = slam.run(scans)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(pallas.LAUNCHES)
    acc, rmse, poses = (x.cpu().numpy() for x in (outs.accepted, outs.rmse, outs.pose))
    n_steps = len(scans) - 1
    rescues, rem = divmod(launches["nn_argmin"] - n_steps, cfg.icp.max_iterations + 1)
    _require(rem == 0 and rescues >= 1, f"offline: the rescue did not run (K3 launches {launches['nn_argmin']})")
    _require(not acc[forced[1:]].any(), "offline: a garbage scan was accepted")
    check_quality("offline", cfg, acc, rmse, poses, gt, state, forced_rejects=forced[1:])
    print(f"[6] Slam(OFFLINE_CONFIG) unchanged, {len(scans)} scans with {int(forced.sum())} garbage: "
          f"{len(scans) / secs:.1f} scans/s; rejected {int((~acc).sum())}; the GICP rescue ran {rescues} times, "
          f"{rescues - int((~acc).sum())} of its runs accepted; accepted outside the garbage "
          f"{acc[~forced[1:]].mean():.3f}; launches {launches}", flush=True)
    for k in total:
        total[k] += launches[k]
    # a step's device time and busy share on the good scans before the garbage (no rescue)
    print(f"[6] offline, the first 19 steps profiled: "
          f"{profile_window(torch, lambda: port.Slam(cfg).run(scans[:20]), 19)}", flush=True)

    # realtime: 12 garbage scans in a row (reseed_after_rejects is 10), fed one by one
    cfg = realtime_cfg
    scans, gt, forced = paused_sequence(25, 12, 12, 25, 33, cfg.n_max)
    pallas.reset_launches()
    slam = port.Slam(cfg)
    runs, reseeds, accepted, rmses, traj = [], 0, [], [], []
    t0 = time.perf_counter()
    for scan in scans:
        out = slam.add_scan(scan)
        runs.append(int(slam.state.reject_run))
        if len(runs) > 1:
            accepted.append(out["accepted"])
            rmses.append(out["rmse"])
            traj.append(out["pose"])
            reseeds += (not out["accepted"]) and runs[-2] == cfg.reseed_after_rejects - 1 and runs[-1] == 0
    secs = time.perf_counter() - t0
    launches = dict(pallas.LAUNCHES)
    acc, rmse, poses = np.array(accepted), np.array(rmses), np.array(traj)
    rescues, rem = divmod(launches["nn_argmin"] - (len(scans) - 1), cfg.icp.max_iterations + 1)
    _require(rem == 0 and rescues >= int(forced.sum()), f"realtime: the rescue ran {rescues} times")
    _require(reseeds >= 1, "realtime: the reseed never ran")
    _require(not acc[forced[1:]].any(), "realtime: a garbage scan was accepted")
    # after the garbage the map is garbage too, until a second reseed rebuilds it from a good scan
    recovering = forced.copy()
    recovering[25 + 12: 25 + 12 + cfg.reseed_after_rejects] = True
    check_quality("realtime", cfg, acc, rmse, poses, gt, slam.state, forced_rejects=recovering[1:])
    print(f"[6] Slam(REALTIME_CONFIG) unchanged, {len(scans)} scans fed one by one, {int(forced.sum())} garbage in a "
          f"row: {len(scans) / secs:.1f} scans/s; rejected {int((~acc).sum())}; the GICP rescue ran {rescues} times, "
          f"{rescues - int((~acc).sum())} of its runs accepted; reseeds {reseeds}; accepted outside the garbage "
          f"and the recovery {acc[~recovering[1:]].mean():.3f}; launches {launches}", flush=True)
    for k in total:
        total[k] += launches[k]

    def feed(n):
        fresh = port.Slam(cfg)
        for scan in scans[:n]:
            fresh.add_scan(scan)

    print(f"[6] realtime, the first 24 steps profiled (fed one by one): {profile_window(torch, lambda: feed(25), 24)}",
          flush=True)

    pair, _ = synthetic_sequence(2, seed=13)
    from icp_slam_yolo_tpu_torch.ops import geometry as geo
    clouds = []
    for scan in pair:
        xy, valid = geo.polar_to_cartesian(torch.from_numpy(scan), offline_cfg.gate)
        clouds.append(xy[valid].numpy())
    r_k, t_k = port.gicp(clouds[1], clouds[0])
    r_c, t_c = port.gicp(clouds[1], clouds[0], device="cpu")
    dt = np.abs(t_k - t_c)
    print(f"[6] gicp() on one pair: card rmse {r_k:.3f} mm, cpu {r_c:.3f} mm; T differs by {dt[:2, 3].max():.3g} mm / "
          f"{dt[:2, :2].max():.3g} (tol 1 mm / 2e-3)", flush=True)
    _require(np.isfinite(r_k) and abs(r_k - r_c) <= 1.0 and dt[:2, 3].max() <= 1.0 and dt[:2, :2].max() <= 2e-3,
             "gicp(): card and cpu differ")
    return total


# ---------------------------------------------------------------- detector

DETECT_CHECKPOINT = "checkpoints/pallet_detect_640.msgpack"
SEGMENT_CHECKPOINT = "checkpoints/pallet_segment_640.msgpack"
# The conv sites of one yolo-n (v8) forward at 640 px outside the whole-block
# C2f kernels, by kernel: (Cin, Cout, input H = W, SiLU, launches per forward)
K5_SITES = ([(64, 64, 80, True, 1), (128, 64, 80, True, 1), (128, 128, 40, True, 1), (256, 128, 40, True, 1),
             (256, 128, 20, True, 1), (512, 256, 20, True, 1)]
            + [(64, cout, h, False, 1) for h in (80, 40, 20) for cout in (64, 1)])
K6_SITES = [(32, 32, 80, True, 4), (64, 64, 40, True, 6), (64, 64, 80, True, 4), (128, 64, 40, True, 2),
            (256, 64, 20, True, 2), (64, 64, 20, True, 2)]
K7_SITES = [(3, 16, 640, True, 1), (16, 32, 320, True, 1), (32, 64, 160, True, 1), (64, 128, 80, True, 1),
            (128, 256, 40, True, 1), (64, 64, 80, True, 1), (128, 128, 40, True, 1)]
# the six single-bottleneck C2f blocks: (Cin, c, F, H = W, shortcut)
K8_SITES = [(32, 16, 32, 160, True), (256, 128, 256, 20, True), (384, 64, 128, 40, False),
            (192, 32, 64, 80, False), (192, 64, 128, 40, False), (384, 128, 256, 20, False)]
LAUNCHES_PER_FORWARD = {"conv3x3s2_silu": 7, "c2f_fused": 6, "conv1x1_silu": 12, "conv3x3_silu": 20}
# The dense conv sites of one YOLO12-L forward at 1024 px (one class), by
# kernel: (Cin, Cout, input H = W, SiLU, launches per forward); the distinct
# kernel sites of `portbench/reference/yolo12.site_work` (a CPU test holds
# the two equal).  The 307-channel sites are the ABlock MLP's; the 768-
# and 256-channel 1x1s without SiLU its ``qkv`` and ``proj``.
YOLO12L_SITES = {
    "conv1x1_silu": [(64, 32, 256, True, 4), (64, 64, 32, False, 1), (64, 64, 64, False, 1), (64, 64, 128, False, 1),
                     (64, 64, 256, True, 2), (128, 64, 128, True, 8), (128, 128, 128, True, 4),
                     (128, 128, 256, True, 1), (256, 1, 32, False, 1), (256, 1, 64, False, 1), (256, 1, 128, False, 1),
                     (256, 128, 32, True, 4), (256, 128, 64, True, 8), (256, 256, 32, False, 8),
                     (256, 256, 32, True, 3), (256, 256, 64, False, 8), (256, 256, 64, True, 5),
                     (256, 256, 128, True, 3), (256, 256, 256, True, 1), (256, 307, 32, True, 8),
                     (256, 307, 64, True, 8), (256, 768, 32, False, 8), (256, 768, 64, False, 8),
                     (307, 256, 32, False, 8), (307, 256, 64, False, 8), (384, 256, 128, True, 1),
                     (512, 256, 32, True, 2), (512, 256, 64, True, 2), (512, 512, 128, True, 1),
                     (768, 256, 64, True, 1), (768, 512, 64, True, 2), (1024, 128, 128, True, 1),
                     (1024, 256, 64, True, 1), (1024, 512, 32, True, 2), (1280, 512, 32, True, 1),
                     (1280, 512, 64, True, 1)],
    "conv3x3_silu": [(32, 32, 256, True, 8), (64, 64, 32, True, 1), (64, 64, 64, True, 1), (64, 64, 128, True, 17),
                     (128, 128, 32, True, 8), (128, 128, 64, True, 16), (256, 64, 128, True, 1),
                     (512, 64, 32, True, 1), (512, 64, 64, True, 1)],
    "conv3x3s2_silu": [(3, 64, 1024, True, 1), (64, 128, 512, True, 1), (256, 256, 128, True, 1),
                       (256, 256, 256, True, 1), (512, 512, 64, True, 2), (512, 512, 128, True, 1)],
}
DETECTOR_KERNELS = {
    "conv1x1_silu": ("icp_slam_yolo_tpu_torch/csrc/conv.cu", "icp_slam_yolo_tpu/ops/pallas/conv_fused.py:102"),
    "conv3x3_silu": ("icp_slam_yolo_tpu_torch/csrc/conv.cu", "icp_slam_yolo_tpu/ops/pallas/conv_fused.py:207"),
    "conv3x3s2_silu": ("icp_slam_yolo_tpu_torch/csrc/conv.cu", "icp_slam_yolo_tpu/ops/pallas/conv_fused.py:304"),
    "c2f_fused": ("icp_slam_yolo_tpu_torch/csrc/c2f.cu", "icp_slam_yolo_tpu/ops/pallas/c2f_fused.py:270"),
}


def _tolerance(dtype_name: str, steps: int, magnitude: float) -> float:
    """float32: 3e-4 of the output's magnitude (another order of summation
    over up to 2304 terms).  bfloat16: ``steps`` bfloat16 steps (2^-8) of the
    output's largest magnitude: the kernel and the plain version hold the same
    float32 sum up to its order, so they differ where a sum falls on the other
    side of a rounding boundary."""
    scale = max(1.0, magnitude)
    return 3e-4 * scale if dtype_name == "float32" else steps * 2.0 ** -8 * scale


def _conv_case(torch, rng, dt, bsz, h, w, cin, cout, k):
    dev = torch.device("cuda")

    def mk(shape, scale):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32, device=dev).to(dt)

    return mk((bsz, h, w, cin), 1.0), mk((k, k, cin, cout), 1.0 / np.sqrt(k * k * cin)), mk((cout,), 0.1)


def _c2f_case(torch, rng, dt, bsz, h, w, cin, c, feat):
    dev = torch.device("cuda")

    def mk(shape, scale, t=dt):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32, device=dev).to(t)

    f32 = torch.float32
    return (mk((bsz, h, w, cin), 1.0), mk((cin, 2 * c), 1.0 / np.sqrt(cin)), mk((2 * c,), 0.1, f32),
            mk((3, 3, c, c), 1.0 / np.sqrt(9 * c)), mk((c,), 0.1, f32), mk((3, 3, c, c), 1.0 / np.sqrt(9 * c)),
            mk((c,), 0.1, f32), mk((3 * c, feat), 1.0 / np.sqrt(3 * c)), mk((feat,), 0.1, f32))


def _c2f_unfused(torch, x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, shortcut):
    """The unfused sequence a C2f block with one bottleneck is without K8:
    four ``F.conv2d`` + ``F.silu`` pairs in the working type, a split, an add
    and a concatenation (what ``fused=False`` runs)."""
    F = torch.nn.functional

    def cba(v, w, b):
        return F.silu(F.conv2d(v, w, b, padding=w.shape[-1] // 2))

    c = w1.shape[0] // 2
    y = cba(x, w1, b1)
    a, b = y[:, :c], y[:, c:]
    t2 = cba(cba(b, wm1, bm1), wm2, bm2)
    return cba(torch.cat([a, b, b + t2 if shortcut else t2], dim=1), w2, b2)


def check_detector_kernels() -> dict:
    """Phase 7: K5-K8 against their plain versions on the card.  Every
    distinct site shape of the forward at batch 1, 2 and 8, bfloat16 (timed)
    and float32 (checked), then edge cases.  Returns the kernels' rows: each
    time is the mean per launch over the launches of one batch-2 forward (the
    stereo tick), the error the largest over all checks."""
    import torch

    from icp_slam_yolo_tpu_torch.ops.pallas import c2f_fused as c2f
    from icp_slam_yolo_tpu_torch.ops.pallas import conv_fused as conv

    from icp_slam_yolo_tpu_torch.ops.pallas import _lib

    F = torch.nn.functional
    lib_c = _lib.lib()
    rng = np.random.default_rng(11)
    wrappers = {
        "conv1x1_silu": (1, 1, lambda x, w, b, act, plan=None: conv.conv1x1_silu(x, w[0, 0], b, act=act, plan=plan)),
        "conv3x3_silu": (3, 1, lambda x, w, b, act, plan=None: conv.conv3x3_silu(x, w, b, plan=plan)),
        "conv3x3s2_silu": (3, 2, lambda x, w, b, act, plan=None: conv.conv3x3s2_silu(x, w, b, plan=plan)),
    }
    kernel = {"conv1x1_silu": "K5", "conv3x3_silu": "K6", "conv3x3s2_silu": "K7", "c2f_fused": "K8"}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sites = {"conv1x1_silu": K5_SITES, "conv3x3_silu": K6_SITES, "conv3x3s2_silu": K7_SITES}
    worst = dict.fromkeys(DETECTOR_KERNELS, 0.0)
    sums = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, by={}) for name in DETECTOR_KERNELS}
    n_checks = 0

    def held(name, what, got, want, dt, steps):
        nonlocal n_checks
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        mag = float(want.float().abs().max())
        tol = _tolerance(str(dt).split(".")[-1], steps, mag)
        _require(got.shape == want.shape and got.dtype == want.dtype and err <= tol,
                 f"{name} {what}: max error {err} against the plain version (tolerance {tol}, magnitude {mag})")
        worst[name] = max(worst[name], err)
        n_checks += 1
        return err, mag

    def repeat_equal(name, what, call):
        """Two launches at one site give the same bits (no atomics; sums in a fixed order)."""
        nonlocal n_checks
        first, second = call(), call()
        torch.cuda.synchronize()
        _require(torch.equal(first, second), f"{name} {what}: two launches differ")
        n_checks += 1

    for name, (k, stride, fn) in wrappers.items():
        # v8n's sites, then YOLO12-L's (checked and timed, outside v8n's per-forward means)
        for (cin, cout, h, act, count), v8 in [(t, True) for t in sites[name]] + [(t, False) for t in YOLO12L_SITES[name]]:
            for dt in (torch.bfloat16, torch.float32):
                for bsz in (1, 2, 8):
                    x, w, b = _conv_case(torch, rng, dt, bsz, h, h, cin, cout, k)
                    what = f"{dt} B={bsz} {cin}->{cout} @{h} act={act}"
                    want = conv.conv_bias_act_plain(x, w, b, stride, act)
                    got = fn(x, w, b, act)
                    err, mag = held(name, what, got, want, dt, 2)
                    if dt != torch.bfloat16:
                        continue
                    shape = (bsz, h // stride, h // stride, cin, cout, k, True, n_sm)
                    plan = conv.conv_plan(*shape)
                    # every other layout (the gathers, tiles, splits and warpgroup kernels): the same bits (one
                    # order of summation), which `detect_pair` needs
                    others = [p for p in conv.layouts(*shape) if p != plan]
                    for other in others:
                        alt = fn(x, w, b, act, plan=other)
                        held(name, f"{what} {other}", alt, want, dt, 2)
                        _held_layout(kernel[name], torch.equal(alt, got), f"{name} {what}: {other} changes the bits")
                    if bsz == 2:
                        repeat_equal(name, what, lambda: fn(x, w, b, act))
                    x_nchw = x.permute(0, 3, 1, 2)
                    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

                    def library():
                        y = F.conv2d(x_nchw, w_oihw, b, stride=stride, padding=k // 2)
                        return F.silu(y) if act else y

                    ms = _device_ms(torch, lambda: fn(x, w, b, act), 10)
                    plain = _device_ms(torch, lambda: conv.conv_bias_act_plain(x, w, b, stride, act), 5)
                    lib = _device_ms(torch, library, 10)
                    ho = h // stride
                    bound = _bound(2.0 * bsz * ho * ho * k * k * cin * cout,
                                   2.0 * (x.numel() + w.numel() + b.numel() + bsz * ho * ho * cout), PEAK_BF16)
                    print(f"[7] {name} bf16 B={bsz} {cin}->{cout} @{h}{'' if act else ' no act'} "
                          f"(x{count} per {'v8n' if v8 else 'YOLO12-L'} forward): "
                          f"err {err:.3g} of {mag:.3g}; {'16-byte' if plan.vec else 'scalar'} gather, tile "
                          f"{plan.bm} x {plan.bn}, {('TMA-fed ' if plan.tma else '') + 'wgmma' if plan.wgmma else f'split {plan.split}'}: device "
                          f"{ms * 1e3:.2f} us ({len(others)} other layouts, the same bits), plain "
                          f"{plain * 1e3:.1f} us, "
                          f"F.conv2d{' + F.silu' if act else ''} {lib * 1e3:.2f} us, bound {bound[0] * 1e3:.3f} us "
                          f"({bound[1]})", flush=True)
                    if bsz == 2 and v8:
                        acc = sums[name]
                        acc["ms"] += count * ms
                        acc["plain_ms"] += count * plain
                        acc["library_ms"] += count * lib
                        acc["bound_ms"] += count * bound[0]
                        acc["by"][bound[1]] = acc["by"].get(bound[1], 0.0) + count * bound[0]

    # the warpgroup layouts (the TMA-fed loop's where Cin and Cout are multiples of 64, the 64-row kernel's where
    # Cout is) against the unsplit 16-byte mma.sync ones and the plain version at every site of v8n and YOLO12-L
    # that has them (the 1x1s of the loop alone), every height, batch 2, 8 and 32: the same bits, the same bits
    # again on a repeat, device times of the loop's widest and 64 x 64 tiles, the 64-row kernel on 64 rows,
    # mma.sync on 128 rows, and the site's bound
    def label(p):
        kind = "TMA-fed loop" if p.tma else "64-row warpgroup kernel" if p.wgmma else "mma.sync"
        return f"{kind} ({p.bm} x {p.bn})"

    for name, (k, stride, fn) in wrappers.items():
        for (cin, cout, h, act, count), v8 in [(t, True) for t in sites[name]] + [(t, False) for t in YOLO12L_SITES[name]]:
            for bsz in (2, 8, 32):
                ho = h // stride
                shape = (bsz, ho, ho, cin, cout, k, True, n_sm)
                listed = conv.layouts(*shape)
                loop = [p for p in listed if p.tma]
                if not loop and (k == 1 or not any(p.wgmma for p in listed)):
                    break
                x, w, b = _conv_case(torch, rng, torch.bfloat16, bsz, h, h, cin, cout, k)
                want = conv.conv_bias_act_plain(x, w, b, stride, act)
                plan = conv.conv_plan(*shape)
                mma = [p for p in listed if p.vec and p.split == 1 and not p.wgmma]
                what = f"bf16 B={bsz} {cin}->{cout} @{h} act={act}"
                got_mma = fn(x, w, b, act, plan=mma[0])
                err, mag = held(name, f"{what} mma.sync", got_mma, want, torch.bfloat16, 2)
                for other in [p for p in listed if p.wgmma] + mma[1:]:
                    got = fn(x, w, b, act, plan=other)
                    held(name, f"{what} {label(other)}", got, want, torch.bfloat16, 2)
                    _held_layout(kernel[name], torch.equal(got, got_mma),
                                 f"{name} {what}: the {label(other)} and {label(mma[0])} differ")
                timed = loop[:1] + loop[-1:] if loop else []
                timed += [p for p in listed if p.wgmma and not p.tma and p.bm == 64] + mma[:1]
                repeat_equal(name, f"{what} {label(timed[0])}", lambda: fn(x, w, b, act, plan=timed[0]))
                times = [_device_ms(torch, lambda: fn(x, w, b, act, plan=p), 10) for p in timed]
                bound = _bound(2.0 * bsz * ho * ho * k * k * cin * cout,
                               2.0 * (x.numel() + w.numel() + b.numel() + bsz * ho * ho * cout), PEAK_BF16)
                print(f"[7] {name} bf16 B={bsz} {cin}->{cout} @{h}{'' if act else ' no act'} "
                      f"(x{count} per {'v8n' if v8 else 'YOLO12-L'} forward): "
                      + ", ".join(f"{label(p)} {t * 1e3:.2f} us" for p, t in zip(timed, times))
                      + f", bound {bound[0] * 1e3:.2f} us ({bound[1]}), {bound[0] / min(times) * 100:.1f} % of it at "
                      f"the fastest; the same bits; err {err:.3g} of {mag:.3g}; the plan takes {label(plan)}"
                      f"{'' if plan.wgmma else f', split {plan.split}'}", flush=True)

    for cin, c, feat, h, shortcut in K8_SITES:
        for dt in (torch.bfloat16, torch.float32):
            for bsz in (1, 2, 8):
                args = _c2f_case(torch, rng, dt, bsz, h, h, cin, c, feat)
                what = f"{dt} B={bsz} Cin {cin} c {c} F {feat} @{h} shortcut={shortcut}"
                want = c2f.c2f_fused_plain(*args, shortcut=shortcut)
                got = c2f.c2f_fused(*args, shortcut=shortcut)
                err, mag = held("c2f_fused", what, got, want, dt, 4)
                if dt != torch.bfloat16:
                    continue
                shape = (bsz, h, h, cin, c, feat, True, n_sm)
                plan = c2f.c2f_plan(*shape)
                # every layout (tiles, clusters, both gathers), its shared memory the kernel's, the same bits
                for other in c2f.layouts(*shape):
                    t, s, v = other
                    _require(lib_c.slam_c2f_smem_bytes(c, t, s, 1, int(v)) == c2f.smem_bytes(c, t, s, True, v),
                             f"c2f_fused: shared memory of the wrapper and the kernel differ at c {c}, {other}")
                    if other != plan:
                        alt = c2f.c2f_fused(*args, shortcut=shortcut, plan=other)
                        held("c2f_fused", f"{what} {other}", alt, want, dt, 4)
                        _held_layout("K8", torch.equal(alt, got), f"c2f_fused {what}: {other} changes the bits")
                if bsz == 2:
                    repeat_equal("c2f_fused", what, lambda: c2f.c2f_fused(*args, shortcut=shortcut))
                x_nchw = args[0].permute(0, 3, 1, 2)
                ws = [w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                      for w in (args[1][None, None], args[3], args[5], args[7][None, None])]
                bs = [b.to(dt) for b in args[2::2]]
                seq = (x_nchw, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3], shortcut)
                ms = _device_ms(torch, lambda: c2f.c2f_fused(*args, shortcut=shortcut), 10)
                variants = {(p.tile, p.cluster): _device_ms(torch, lambda: c2f.c2f_fused(*args, shortcut=shortcut, plan=p), 5)
                            for p in c2f.layouts(*shape) if p.tile >= 4 and p.vec == plan.vec and p != plan}
                plain = _device_ms(torch, lambda: c2f.c2f_fused_plain(*args, shortcut=shortcut), 5)
                lib = _device_ms(torch, lambda: _c2f_unfused(torch, *seq), 10)
                n_w = sum(a.numel() for a in args[1::2])
                bound = _bound(2.0 * bsz * h * h * (cin * 2 * c + 18 * c * c + 3 * c * feat),
                               2.0 * (args[0].numel() + n_w + bsz * h * h * feat) + 4.0 * (4 * c + feat), PEAK_BF16)
                print(f"[7] c2f_fused bf16 B={bsz} Cin {cin} c {c} F {feat} @{h} shortcut {shortcut}: err {err:.3g} of "
                      f"{mag:.3g}; tile {plan.tile}, cluster {plan.cluster}: device {ms * 1e3:.2f} us (others: "
                      f"{', '.join(f'{t}/{s_}: {v * 1e3:.1f}' for (t, s_), v in variants.items())}), "
                      f"plain {plain * 1e3:.1f} us, the unfused sequence (4 F.conv2d + F.silu, add, concat) "
                      f"{lib * 1e3:.2f} us, bound {bound[0] * 1e3:.3f} us ({bound[1]})", flush=True)
                if bsz == 2:
                    acc = sums["c2f_fused"]
                    acc["ms"] += ms
                    acc["plain_ms"] += plain
                    acc["library_ms"] += lib
                    acc["bound_ms"] += bound[0]
                    acc["by"][bound[1]] = acc["by"].get(bound[1], 0.0) + bound[0]

    # edge cases: odd channel counts (no vector load may assume a multiple of
    # 8), one output channel, images of one tile, ragged last tiles, 2 x 2
    for dt in (torch.bfloat16, torch.float32):
        for name, (k, stride, fn) in wrappers.items():
            for bsz, h, w, cin, cout in ((3, 10, 6, 5, 7), (1, 2, 2, 3, 1), (2, 18, 22, 192, 3), (1, 4, 4, 384, 65)):
                x, wt, b = _conv_case(torch, rng, dt, bsz, h, w, cin, cout, k)
                for act in ((True, False) if k == 1 else (True,)):
                    want = conv.conv_bias_act_plain(x, wt, b, stride, act)
                    got = fn(x, wt, b, act)
                    held(name, f"edge {dt} B={bsz} {h}x{w} {cin}->{cout} act={act}", got, want, dt, 2)
                    shape = (bsz, h // stride, w // stride, cin, cout, k, dt == torch.bfloat16, n_sm)
                    for other in conv.layouts(*shape):  # every layout, the splits on the scalar gather among them
                        if other != conv.conv_plan(*shape):
                            alt = fn(x, wt, b, act, plan=other)
                            held(name, f"edge {dt} B={bsz} {h}x{w} {cin}->{cout} act={act} {other}", alt, want, dt, 2)
                            _held_layout(kernel[name], torch.equal(alt, got),
                                         f"{name} edge {dt} B={bsz} {h}x{w} {cin}->{cout}: {other} changes the bits")
        for bsz, h, w, cin, c, feat in ((1, 4, 4, 32, 16, 32), (2, 13, 11, 24, 8, 20), (1, 8, 8, 7, 5, 3),
                                        (1, 9, 17, 40, 24, 48), (2, 5, 3, 384, 12, 16), (1, 9, 13, 64, 32, 64),
                                        (1, 6, 10, 7, 16, 32)):
            args = _c2f_case(torch, rng, dt, bsz, h, w, cin, c, feat)
            shape = (bsz, h, w, cin, c, feat, dt == torch.bfloat16, n_sm)
            for shortcut in (True, False):
                want = c2f.c2f_fused_plain(*args, shortcut=shortcut)
                what = f"edge {dt} B={bsz} {h}x{w} Cin {cin} c {c} F {feat} shortcut={shortcut}"
                got = c2f.c2f_fused(*args, shortcut=shortcut)
                held("c2f_fused", what, got, want, dt, 4)
                for other in c2f.layouts(*shape):  # every tile, cluster and gather
                    if other != c2f.c2f_plan(*shape):
                        alt = c2f.c2f_fused(*args, shortcut=shortcut, plan=other)
                        held("c2f_fused", f"{what} {other}", alt, want, dt, 4)
                        _held_layout("K8", torch.equal(alt, got), f"c2f_fused {what}: {other} changes the bits")
    print(f"[7] K5-K8: {n_checks} checks against the plain versions passed (float32: 3e-4 of the magnitude; bfloat16: "
          f"2 steps of 2^-8 of the magnitude for K5-K7, 4 for K8, whose three intermediate roundings can each flip)",
          flush=True)
    layouts_checked(("K5", "K6", "K7", "K8"))

    rows = {}
    for name, (source, replaces) in DETECTOR_KERNELS.items():
        acc, n = sums[name], LAUNCHES_PER_FORWARD[name]
        rows[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces, max_abs_err=worst[name],
            ms=acc["ms"] / n, plain_ms=acc["plain_ms"] / n, bound_ms=acc["bound_ms"] / n,
            bound_by=max(acc["by"], key=acc["by"].get), library_ms=acc["library_ms"] / n)
        print(f"[7] {name}: over the {n} launches of one bf16 batch-2 forward, mean per launch: device "
              f"{rows[name]['ms'] * 1e3:.2f} us, plain {rows[name]['plain_ms'] * 1e3:.1f} us, library "
              f"{rows[name]['library_ms'] * 1e3:.2f} us, bound {rows[name]['bound_ms'] * 1e3:.3f} us "
              f"(mostly {rows[name]['bound_by']})", flush=True)
    return rows


def synthetic_frame(seed: int, h: int = 480, w: int = 640) -> np.ndarray:
    """A seeded camera-like frame, uint8 HWC: a floor and wall gradient,
    a few boxes with slats (pallet-like), sensor noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([90 + 60 * yy / h, 85 + 50 * yy / h, 80 + 40 * xx / w], axis=-1)
    for _ in range(6):
        bw, bh = int(rng.integers(60, 220)), int(rng.integers(30, 110))
        x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(h // 3, h - bh))
        img[y0:y0 + bh, x0:x0 + bw] = rng.uniform(90, 200, 3) * np.array([1.0, 0.8, 0.55])
        for sx in range(x0 + bw // 6, x0 + bw, max(bw // 3, 1)):
            img[y0 + bh // 3:y0 + bh, sx:sx + max(bw // 10, 2)] *= 0.35
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def pallet_image(rng, h: int = 480, w: int = 640):
    """A seeded frame with 1-3 box-shaped "pallets" (a face with slats,
    turned by up to 15 degrees) on a floor and wall gradient, uint8 HWC, and
    each pallet's corners ``(4, 2)`` in pixels, in label order (the top
    edge first)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([90 + 60 * yy / h, 85 + 50 * yy / h, 80 + 40 * xx / w], axis=-1)
    corners = []
    for _ in range(int(rng.integers(1, 4))):
        bw, bh = rng.uniform(w / 8, 0.4 * w), rng.uniform(h / 12, h / 4)
        cx, cy = rng.uniform(0.6 * bw, w - 0.6 * bw), rng.uniform(h / 3, h - 0.6 * bh - h / 24)
        a = np.radians(rng.uniform(-15, 15))
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        local = np.stack([(xx - cx) * np.cos(a) + (yy - cy) * np.sin(a), -(xx - cx) * np.sin(a) + (yy - cy) * np.cos(a)])
        face = (np.abs(local[0]) <= bw / 2) & (np.abs(local[1]) <= bh / 2)
        img[face] = rng.uniform(120, 210, 3) * np.array([1.0, 0.8, 0.55])
        slats = face & (local[1] > -bh / 6) & (np.mod(local[0] + bw / 2, bw / 3) < bw / 10)
        img[slats] *= 0.35
        corners.append(np.array([[cx, cy]]) + np.array([[-bw, -bh], [bw, -bh], [bw, bh], [-bw, bh]]) / 2 @ rot.T)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8), corners


def pallet_dataset(root: str, seed: int, n_train: int = 48, n_val: int = 16, h: int = 480, w: int = 640) -> str:
    """Write a seeded YOLO-layout dataset of PNG frames (`pallet_image`):
    ``{train,val}/images/*.png`` with ``labels/`` (boxes: ``0 cx cy w h``),
    ``labels_poly/`` (the corners as a polygon: the obb and segment tasks)
    and ``labels_pose/`` (the box and the corners as keypoints, visible).
    Returns ``root``."""
    import os

    from icp_slam_yolo_tpu_torch.utils.images import encode_png

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        dirs = {k: os.path.join(root, split, k) for k in ("images", "labels", "labels_poly", "labels_pose")}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        for i in range(n):
            img, corners = pallet_image(rng, h, w)
            with open(os.path.join(dirs["images"], f"{i:04d}.png"), "wb") as f:
                f.write(encode_png(img))
            rows = {"labels": [], "labels_poly": [], "labels_pose": []}
            for c in corners:
                n_c = np.clip(c / np.array([w, h]), 0.0, 1.0)
                lo, hi = n_c.min(0), n_c.max(0)
                box = f"{(lo[0] + hi[0]) / 2:.6f} {(lo[1] + hi[1]) / 2:.6f} {hi[0] - lo[0]:.6f} {hi[1] - lo[1]:.6f}"
                rows["labels"].append(f"0 {box}")
                rows["labels_poly"].append("0 " + " ".join(f"{v:.6f}" for v in n_c.reshape(-1)))
                rows["labels_pose"].append(f"0 {box} " + " ".join(f"{x:.6f} {y:.6f} 2" for x, y in n_c))
            for kind, lines in rows.items():
                with open(os.path.join(dirs[kind], f"{i:04d}.txt"), "w") as f:
                    f.write("\n".join(lines) + "\n")
    return root


TICK_CHECKPOINT = "checkpoints/pallet_detect_v12_640.msgpack"
TICK_DISPARITY_PX = 24


def stereo_pair(seed: int, disparity: int = TICK_DISPARITY_PX) -> tuple[np.ndarray, np.ndarray]:
    """A seeded stereo pair: `synthetic_frame` for the left eye and the same
    frame shifted ``disparity`` pixels to the left for the right eye."""
    left = synthetic_frame(seed)
    return left, np.roll(left, -disparity, axis=1)


def tick(slam, detector, landmarks, scan: np.ndarray, left: np.ndarray, right: np.ndarray):
    """One tick of the fused SLAM + detect loop (``BASELINE.json``
    configuration 4): the SLAM step on ``scan`` (``Slam.add_scan``), the
    stereo pair's detect (``Detector.detect_pair``: one batch-2 forward,
    decode, NMS), and the first detection of each eye fused into
    ``landmarks`` at the new pose (`fusion.fuse_stereo_pair`).  Returns the
    step's outputs and the fusion's (alignment, landmark index), or None
    where an eye saw nothing."""
    from icp_slam_yolo_tpu_torch.fusion import fuse_stereo_pair

    step = slam.add_scan(scan)
    out_left, out_right = detector.detect_pair(left, right)
    return step, fuse_stereo_pair(out_left, out_right, slam.pose, landmarks)


def _head_tensors(outs):
    if isinstance(outs, tuple):
        return [t for level in outs[0] for t in level] + [outs[1]]
    return [t for level in outs for t in level]


def _card_against_cpu(d_card, d_cpu, conf: float) -> str:
    """Two images' `Detections` of the card (kernels) and of the CPU (plain
    versions), float32: the same candidates kept (but those at the
    threshold), their boxes within 0.05 model pixels, scores within 2e-3 of
    their value (they are ~4e-5 here), classes equal.  Returns a summary."""
    score_tol, box_tol = 2e-3, 0.05
    n_compared, worst_box, worst_score = 0, 0.0, 0.0
    for i in range(2):
        rows_card = {int(a): r for r, a in enumerate(d_card.anchor_idx[i].tolist()) if a >= 0}
        rows_cpu = {int(a): r for r, a in enumerate(d_cpu.anchor_idx[i].tolist()) if a >= 0}
        for mine, other, d_mine, d_other in ((rows_card, rows_cpu, d_card, d_cpu), (rows_cpu, rows_card, d_cpu, d_card)):
            for anchor, r in mine.items():
                if abs(float(d_mine.scores[i, r]) - conf) <= score_tol * conf:
                    continue  # at the threshold: may fall on either side
                _require(anchor in other, f"float32 card vs cpu: anchor {anchor} of image {i} kept on one side only")
                q = other[anchor]
                worst_box = max(worst_box, float((d_mine.boxes[i, r].cpu() - d_other.boxes[i, q].cpu()).abs().max()))
                worst_score = max(worst_score, abs(float(d_mine.scores[i, r]) / float(d_other.scores[i, q]) - 1.0))
                _require(int(d_mine.classes[i, r]) == int(d_other.classes[i, q]), "float32 card vs cpu: classes differ")
                n_compared += 1
    _require(n_compared > 0 and worst_box <= box_tol and worst_score <= score_tol,
             f"float32 card vs cpu: boxes differ by {worst_box} px, scores by {worst_score}")
    return (f"{n_compared // 2} kept candidates on both sides, boxes within {worst_box:.3g} px (tolerance {box_tol}), "
            f"scores within {worst_score:.3g} of their value (tolerance {score_tol}), classes equal")


def detector_path() -> dict:
    """Phase 8: the detector's serving path on the card.  Returns the launch
    counts of the run between the counters' reset and their reading."""
    import torch

    import icp_slam_yolo_tpu_torch as port
    from icp_slam_yolo_tpu_torch.ops import pallas

    # so low that NMS has candidates: the trained weights score these frames (they show no pallet) at 2e-5 to 1e-4
    conf = 1e-6
    t0 = time.perf_counter()
    det = port.detector_from_checkpoint(DETECT_CHECKPOINT, conf_threshold=conf, pallas_convs=True)
    load_s = time.perf_counter() - t0
    frames = [synthetic_frame(s) for s in range(40, 50)]
    det(frames[0])  # warm-up
    torch.cuda.synchronize()

    # -- the main path: counters zeroed just before, read just after
    pallas.reset_launches()
    per_forward, tma_per_forward = [], []

    def counted(fn):
        before = dict(pallas.LAUNCHES)
        out = fn()
        per_forward.append({k: pallas.LAUNCHES[k] - before[k] for k in LAUNCHES_PER_FORWARD})
        tma_per_forward.append(pallas.LAUNCHES["conv_tma"] - before["conv_tma"])
        return out

    t0 = time.perf_counter()
    singles = [counted(lambda f=f: det(f)) for f in frames[:4]]
    call_s = (time.perf_counter() - t0) / 4
    t0 = time.perf_counter()
    pair = counted(lambda: det.detect_pair(frames[0], frames[1]))
    pair_s = time.perf_counter() - t0
    batch8 = np.concatenate([det.preprocess(f)[0] for f in frames[:8]])
    t0 = time.perf_counter()
    dets8 = counted(lambda: det.predict_batch(batch8))
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = dict(pallas.LAUNCHES)

    for counts in per_forward:
        _require(counts == LAUNCHES_PER_FORWARD, f"detector: launches per forward {counts}, expected {LAUNCHES_PER_FORWARD}")
    n_valid = [len(o["boxes"]) for o in singles]
    for o in singles + list(pair):
        _require(o["boxes"].shape == (len(o["scores"]), 4) and np.isfinite(o["boxes"]).all()
                 and np.isfinite(o["scores"]).all() and (o["scores"] >= conf).all() and (o["classes"] == 0).all(),
                 "detector: malformed detections")
    _require(sum(n_valid) > 0, "detector: no candidate above the threshold on any frame")
    _require(tuple(dets8.boxes.shape) == (8, det.max_detections, 4) and bool(torch.isfinite(dets8.boxes).all()),
             "predict_batch(8): malformed detections")
    for got, want in zip(pair, singles[:2]):
        _require(len(got["boxes"]) == len(want["boxes"]) and np.allclose(got["boxes"], want["boxes"], atol=1e-3)
                 and np.allclose(got["scores"], want["scores"], atol=1e-5)
                 and np.array_equal(got["classes"], want["classes"]), "detect_pair differs from two single calls")
    exact = all(np.array_equal(g["boxes"], w["boxes"]) and np.array_equal(g["scores"], w["scores"])
                for g, w in zip(pair, singles[:2]))
    for i in range(2):  # predict_batch's first rows against the single calls, in model pixels
        valid = dets8.valid[i].cpu().numpy()
        _require(int(valid.sum()) == n_valid[i] and np.allclose(dets8.scores[i].cpu().numpy()[valid], singles[i]["scores"], atol=1e-5),
                 "predict_batch(8) differs from the single calls")
    print(f"[8] detector_from_checkpoint({DETECT_CHECKPOINT!r}, pallas_convs=True): yolo-n v8 at 640 px, bfloat16, loaded in "
          f"{load_s:.2f} s; __call__ on 4 synthetic 480x640 frames {call_s * 1e3:.2f} ms per frame (host letterbox and "
          f"copies included), detect_pair {pair_s * 1e3:.2f} ms, predict_batch(8) {batch_s * 1e3:.2f} ms; detections above "
          f"{conf} per frame {n_valid}, best scores {[float(f'{o["scores"][0]:.3g}') if len(o['scores']) else None for o in singles]}; "
          f"detect_pair equal to two single calls (bit equal: {exact}); launches per forward {per_forward[0]} at batch 1, 2 "
          f"and 8, of them through the TMA-fed warpgroup loop {tma_per_forward[0]}, {tma_per_forward[4]} and "
          f"{tma_per_forward[5]} of {sum(LAUNCHES_PER_FORWARD.values()) - LAUNCHES_PER_FORWARD['c2f_fused']} K5-K7; "
          f"launches {launches}", flush=True)

    # -- fused against unfused head outputs on the card, bfloat16, and both against float32
    unfused = port.detector_from_checkpoint(DETECT_CHECKPOINT, conf_threshold=conf, pallas_convs=False)
    full = port.detector_from_checkpoint(DETECT_CHECKPOINT, conf_threshold=conf, pallas_convs=True,
                                         compute_dtype=torch.float32)
    images = torch.from_numpy(batch8[:2]).cuda()
    with torch.no_grad():
        heads = [_head_tensors(d.model(images)) for d in (det, unfused, full)]
    worst_fu, worst_f, worst_u, mag = 0.0, 0.0, 0.0, 0.0
    for a, b, c in zip(*heads):
        worst_fu = max(worst_fu, float((a.float() - b.float()).abs().max()))
        worst_f = max(worst_f, float((a.float() - c).abs().max()))
        worst_u = max(worst_u, float((b.float() - c).abs().max()))
        mag = max(mag, float(c.abs().max()))
        _require(a.shape == b.shape and bool(torch.isfinite(a.float()).all()), "fused head outputs malformed")
    # bfloat16 keeps 8 significant bits; ~25 stacked convs each round once
    # (fused) or three times (unfused: conv, bias, SiLU), so the two paths
    # drift apart by a few per cent of the logits' magnitude.  Held: the
    # fused path is within 4 % of the magnitude of the unfused one, and no
    # further from the float32 forward than twice the unfused path is.
    tol = 0.04 * mag
    print(f"[8] head outputs, bfloat16, batch 2: fused vs unfused max diff {worst_fu:.4g} (tolerance {tol:.4g} = 4 % of the "
          f"largest float32 logit {mag:.4g}); against the float32 forward: fused {worst_f:.4g}, unfused {worst_u:.4g}",
          flush=True)
    _require(worst_fu <= tol and worst_f <= max(2.0 * worst_u, tol / 2), "fused and unfused head outputs differ")

    # -- float32: the card (kernels) against the port on the CPU (plain versions)
    cpu = port.detector_from_checkpoint(DETECT_CHECKPOINT, conf_threshold=conf, pallas_convs=True,
                                        compute_dtype=torch.float32, device="cpu")
    t0 = time.perf_counter()
    d_cpu = cpu.predict_batch(batch8[:2])
    cpu_s = time.perf_counter() - t0
    d_card = full.predict_batch(batch8[:2])
    print(f"[8] float32, the card (kernels) against the port on the CPU (plain versions, {cpu_s:.1f} s for 2 frames): "
          + _card_against_cpu(d_card, d_cpu, conf), flush=True)

    # -- another task: the segment checkpoint once through the fused path
    seg = port.detector_from_checkpoint(SEGMENT_CHECKPOINT, conf_threshold=conf, pallas_convs=True)
    before = dict(pallas.LAUNCHES)
    out = seg(frames[2])
    seg_launches = {k: pallas.LAUNCHES[k] - before[k] for k in LAUNCHES_PER_FORWARD}
    n = len(out["boxes"])
    _require(n > 0 and out["mask_coeffs"].shape == (n, 32) and out["masks"].shape == (n, 160, 160)
             and np.isfinite(out["masks"]).all() and out["masks"].min() >= 0.0 and out["masks"].max() <= 1.0,
             "segment detector: malformed extras")
    print(f"[8] {SEGMENT_CHECKPOINT}: task segment, {n} detections above {conf}, mask coefficients {out['mask_coeffs'].shape}, "
          f"masks {out['masks'].shape} in [0, 1]; launches of its forward {seg_launches}", flush=True)
    return launches


def detector_times(path: str = DETECT_CHECKPOINT) -> None:
    """Phase 9: a forward of ``path``'s detector (``predict_batch`` on a
    batch already on the card: model, top-K decode, NMS) at batch 1, 2, 8
    and 32, fused (K5-K8) and unfused (``F.conv2d`` + ``F.silu``), bfloat16:
    wall per forward in turns (fused, unfused, unfused, fused) over 20
    forwards (8 at batch 32), then a profiler window each."""
    import torch

    import icp_slam_yolo_tpu_torch as port

    dets = {"fused": port.detector_from_checkpoint(path, conf_threshold=1e-6, pallas_convs=True),
            "unfused": port.detector_from_checkpoint(path, conf_threshold=1e-6, pallas_convs=False)}
    tag = "" if path == DETECT_CHECKPOINT else f" {path.split('/')[-1].split('.')[0]}"
    one = np.concatenate([dets["fused"].preprocess(synthetic_frame(60 + i))[0] for i in range(8)])
    for bsz in (1, 2, 8, 32):
        images = torch.from_numpy(np.tile(one, (4, 1, 1, 1))[:bsz]).cuda()
        n = 20 if bsz <= 8 else 8
        walls = []
        for which in ("fused", "unfused", "unfused", "fused"):
            det = dets[which]
            det.predict_batch(images)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                det.predict_batch(images)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / n * 1e3)
        print(f"[9]{tag} forward at batch {bsz}, bfloat16, wall ms per forward in turns: fused {walls[0]:.3f}, unfused "
              f"{walls[1]:.3f}, unfused {walls[2]:.3f}, fused {walls[3]:.3f}", flush=True)
        for which in ("fused", "unfused"):
            det = dets[which]

            def window():
                for _ in range(n):
                    det.predict_batch(images)

            print(f"[9]{tag} batch {bsz} {which}, profiled {n} forwards: " + profile_window(torch, window, n), flush=True)


# The v11 and v12 checkpoints, and the launches of K5-K8 in one forward of each
FAMILY_CHECKPOINTS = {
    "checkpoints/pallet_detect_v12_640.msgpack": {"conv3x3s2_silu": 7, "c2f_fused": 0, "conv1x1_silu": 82,
                                                  "conv3x3_silu": 32},
    "checkpoints/pallet_obb_v11_640.msgpack": {"conv3x3s2_silu": 7, "c2f_fused": 0, "conv1x1_silu": 44,
                                               "conv3x3_silu": 37},
}


class HeldKernels:
    """Shims around the K5-K8 wrappers, in place inside a ``with`` block,
    that hold each launch against its plain version on the same input
    (`_tolerance`: 2 bfloat16 steps for K5-K7, 4 for K8; float32 3e-4).
    ``worst`` is each kernel's largest error, ``held`` its launches held,
    ``shapes`` the distinct (kernel, input shape, Cout, act) seen."""

    CONVS = ("conv1x1_silu", "conv3x3_silu", "conv3x3s2_silu")

    def __init__(self):
        from icp_slam_yolo_tpu_torch.ops.pallas import c2f_fused as c2f
        from icp_slam_yolo_tpu_torch.ops.pallas import conv_fused as conv

        self.conv, self.c2f = conv, c2f
        self.real = {name: getattr(conv, name) for name in self.CONVS}
        self.real["c2f_fused"] = c2f.c2f_fused
        self.worst, self.held, self.shapes = dict.fromkeys(self.real, 0.0), dict.fromkeys(self.real, 0), set()

    def _check(self, name, x, got, want, steps, cout, act=True):
        err = float((got.float() - want.float()).abs().max())
        tol = _tolerance(str(x.dtype).split(".")[-1], steps, float(want.float().abs().max()))
        _require(got.shape == want.shape and err <= tol,
                 f"{name} {tuple(x.shape)} {x.dtype} -> {cout} act={act}: error {err} (tolerance {tol})")
        self.worst[name] = max(self.worst[name], err)
        self.held[name] += 1
        self.shapes.add((name, tuple(x.shape), cout, act))

    def _conv_shim(self, name):
        def call(x, w, b, act=True, **kw):
            real = self.real[name]
            got = real(x, w, b, act=act, **kw) if name == "conv1x1_silu" else real(x, w, b, **kw)
            hwio = w[None, None] if name == "conv1x1_silu" else w
            want = self.conv.conv_bias_act_plain(x, hwio, b, 2 if name == "conv3x3s2_silu" else 1, act)
            self._check(name, x, got, want, 2, hwio.shape[-1], act)
            return got
        return call

    def _c2f_shim(self, x, *weights, shortcut=True, **kw):
        got = self.real["c2f_fused"](x, *weights, shortcut=shortcut, **kw)
        self._check("c2f_fused", x, got, self.c2f.c2f_fused_plain(x, *weights, shortcut=shortcut), 4, got.shape[-1])
        return got

    def __enter__(self):
        for name in self.CONVS:
            setattr(self.conv, name, self._conv_shim(name))
        self.c2f.c2f_fused = self._c2f_shim
        return self

    def __exit__(self, *exc):
        for name in self.CONVS:
            setattr(self.conv, name, self.real[name])
        self.c2f.c2f_fused = self.real["c2f_fused"]


def check_family_sites() -> dict:
    """Phase 7, continued: K5-K7 at every conv site of the v11 and v12
    checkpoints' forwards on the card (640 px; batch 1, 2 and 8; bfloat16
    and float32), each launch held against its plain version on the same
    input (`HeldKernels`).  Returns each kernel's largest error."""
    import torch

    import icp_slam_yolo_tpu_torch as port

    frames = [synthetic_frame(s) for s in range(70, 78)]
    with HeldKernels() as held:
        for path in FAMILY_CHECKPOINTS:
            for dt in (torch.bfloat16, torch.float32):
                det = port.detector_from_checkpoint(path, conf_threshold=1e-6, pallas_convs=True, compute_dtype=dt)
                det(frames[0])
                det.detect_pair(frames[1], frames[2])
                det.predict_batch(np.concatenate([det.preprocess(f)[0] for f in frames]))
    torch.cuda.synchronize()
    worst = {k: held.worst[k] for k in HeldKernels.CONVS}
    print(f"[7] v11/v12 checkpoints' conv sites on the card (batch 1, 2, 8; bfloat16 and float32): "
          f"{sum(held.held.values())} launches at {len(held.shapes)} distinct shapes, each within 2 bfloat16 steps "
          f"(float32: 3e-4) of its plain version; largest errors {worst}", flush=True)
    return worst


def family_paths() -> list[dict]:
    """Phase 8, continued: the v11 and v12 checkpoints through the fused path
    on the card, bfloat16, 640 px: ``__call__``, ``detect_pair`` and
    ``predict_batch(8)``, each checkpoint's run between a reset and a
    reading of the launch counters (K5 / K6 / K7 launches a forward as the
    JAX routing gives them, K8 none); fused against unfused head outputs;
    float32 on the card against the port on the CPU.  Returns each run's
    launch counts."""
    import torch

    import icp_slam_yolo_tpu_torch as port
    from icp_slam_yolo_tpu_torch.ops import pallas

    conf = 1e-6
    frames = [synthetic_frame(s) for s in range(80, 90)]
    runs = []
    for path, expected in FAMILY_CHECKPOINTS.items():
        det = port.detector_from_checkpoint(path, conf_threshold=conf, pallas_convs=True)
        det(frames[0])  # warm-up
        torch.cuda.synchronize()
        batch8 = np.concatenate([det.preprocess(f)[0] for f in frames[:8]])
        per_forward = []

        def counted(fn):
            before = dict(pallas.LAUNCHES)
            out = fn()
            per_forward.append({k: pallas.LAUNCHES[k] - before[k] for k in expected})
            return out

        pallas.reset_launches()
        t0 = time.perf_counter()
        singles = [counted(lambda f=f: det(f)) for f in frames[:2]]
        pair = counted(lambda: det.detect_pair(frames[0], frames[1]))
        dets8 = counted(lambda: det.predict_batch(batch8))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs.append(dict(pallas.LAUNCHES))
        for counts in per_forward:
            _require(counts == expected, f"{path}: launches per forward {counts}, expected {expected}")
        extra = {"detect": None, "obb": "angles"}[det.task]
        for o in singles + list(pair):
            _require(o["boxes"].shape == (len(o["scores"]), 4) and np.isfinite(o["boxes"]).all()
                     and (o["scores"] >= conf).all() and (extra is None or o[extra].shape == (len(o["scores"]),)),
                     f"{path}: malformed detections")
        _require(sum(len(o["boxes"]) for o in singles) > 0, f"{path}: no candidate above the threshold")
        _require(tuple(dets8.boxes.shape) == (8, det.max_detections, 4) and bool(torch.isfinite(dets8.boxes).all()),
                 f"{path}: predict_batch(8) malformed")
        for got, want in zip(pair, singles):
            _require(len(got["boxes"]) == len(want["boxes"]) and np.allclose(got["boxes"], want["boxes"], atol=1e-3)
                     and np.allclose(got["scores"], want["scores"], atol=1e-5), f"{path}: detect_pair differs from two calls")
        unfused = port.detector_from_checkpoint(path, conf_threshold=conf, pallas_convs=False)
        full = port.detector_from_checkpoint(path, conf_threshold=conf, pallas_convs=True, compute_dtype=torch.float32)
        images = torch.from_numpy(batch8[:2]).cuda()
        with torch.no_grad():
            heads = [_head_tensors(d.model(images)) for d in (det, unfused, full)]
        worst_fu, worst_f, worst_u, mag = 0.0, 0.0, 0.0, 0.0
        for a, b, c in zip(*heads):
            worst_fu = max(worst_fu, float((a.float() - b.float()).abs().max()))
            worst_f = max(worst_f, float((a.float() - c).abs().max()))
            worst_u = max(worst_u, float((b.float() - c).abs().max()))
            mag = max(mag, float(c.abs().max()))
        tol = 0.04 * mag  # as for v8 (phase 8)
        _require(worst_fu <= tol and worst_f <= max(2.0 * worst_u, tol / 2), f"{path}: fused and unfused head outputs differ")
        cpu = port.detector_from_checkpoint(path, conf_threshold=conf, pallas_convs=True, compute_dtype=torch.float32,
                                            device="cpu")
        cmp = _card_against_cpu(full.predict_batch(batch8[:2]), cpu.predict_batch(batch8[:2]), conf)
        print(f"[8] {path} (family {det.model.family}, task {det.task}), fused, bfloat16: __call__ x2, detect_pair, "
              f"predict_batch(8) in {secs * 1e3:.1f} ms, launches per forward {per_forward[0]} at batch 1, 2 and 8; "
              f"head outputs, batch 2: fused vs unfused {worst_fu:.4g} (tolerance {tol:.4g}), against float32 fused "
              f"{worst_f:.4g}, unfused {worst_u:.4g}; float32 card vs CPU: {cmp}", flush=True)
    return runs


def yolo12_seeded(variant: str, img_size: int, seed: int, device):
    """A YOLO12 state dict in Ultralytics' layout with seeded weights (zero-
    mean filters at unit gain, BatchNorm scales 0.1-0.3 and ``gamma`` 1.0 as
    the benchmark's cell has them: wider scales make the seeded net chaotic,
    its float32 rounding amplified past any tolerance at the head),
    its BatchNorm statistics calibrated on 8 seeded frames, and those frames
    letterboxed to ``img_size``, NHWC float32 on ``device``."""
    import torch

    from icp_slam_yolo_tpu_torch.models.detect import letterbox_transform
    from icp_slam_yolo_tpu_torch.reference_impl import yolo12 as R

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in R.state_layout(variant, 1):
        z = torch.randn(shape, generator=g)
        if key.endswith("dfl.conv.weight"):
            sd[key] = torch.arange(16.0).view(shape)
        elif len(shape) == 4:
            sd[key] = (z - z.mean((1, 2, 3), keepdim=True)) / (shape[1] * shape[2] * shape[3]) ** 0.5
        elif key.endswith("bn.weight"):
            sd[key] = 0.1 + 0.2 * torch.rand(shape, generator=g)
        elif key.endswith("running_var"):
            sd[key] = 0.5 + torch.rand(shape, generator=g)
        elif key.endswith("gamma"):
            sd[key] = torch.ones(shape)
        else:
            sd[key] = 0.1 * z
    frames = []
    for f in (synthetic_frame(s) for s in range(seed, seed + 8)):
        scale, px, py = letterbox_transform(f.shape[1], f.shape[0], img_size)
        img = torch.from_numpy(f).float().div(255).permute(2, 0, 1)[None]
        nh, nw = round(f.shape[0] * scale), round(f.shape[1] * scale)
        canvas = torch.full((1, 3, img_size, img_size), 114 / 255)
        canvas[..., int(py):int(py) + nh, int(px):int(px) + nw] = torch.nn.functional.interpolate(img, (nh, nw))
        frames.append(canvas)
    images = torch.cat(frames).to(device)
    sd = R.calibrate({"variant": variant, "num_classes": 1, "reg_max": 16, "bn_eps": 1e-3},
                     {k: v.to(device) for k, v in sd.items()}, images)
    return sd, images.permute(0, 2, 3, 1).contiguous()


def yolo12_path() -> dict:
    """Phase 8, continued: YOLO12-L (the cell ``detect-yolo12l-b32``'s model)
    through ``Detector.predict_batch`` on the card at 1024 px, seeded
    weights, bfloat16, fused: the K5 / K6 / K7 launches of one forward at
    batch 2 and 8 against the count of `YOLO12L_SITES` (K8 none); then every
    launch of a batch-2 forward held against its plain version on its input
    (`HeldKernels`, bfloat16 and float32); then the float32 fused head
    outputs against the plain reference's (`reference_impl/yolo12.py`, TF32
    off) on the card, their root-mean-square gap over the reference's spread
    within 5e-3 (the benchmark's float32 program reads 3e-4 to 5e-4 there; a
    wrong kernel reads ~1).  Returns the launch counts."""
    import torch

    from icp_slam_yolo_tpu_torch.io.torch_import import convert_state_dict, validate_against_model
    from icp_slam_yolo_tpu_torch.models.detect import Detector
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO
    from icp_slam_yolo_tpu_torch.ops import pallas
    from icp_slam_yolo_tpu_torch.reference_impl import yolo12 as R

    dev = torch.device("cuda")
    sd, images = yolo12_seeded("l", 1024, 90, dev)
    with torch.random.fork_rng(devices=[]):
        full = validate_against_model(convert_state_dict({k: v.cpu() for k, v in sd.items()}, "yolo12"),
                                      YOLO(num_classes=1, variant="l", family="yolo12"))

    def detector(dt):
        return Detector(num_classes=1, variant="l", family="yolo12", img_size=1024, conf_threshold=0.25,
                        compute_dtype=dt, fold_bn=True, pallas_convs=True, device=dev, state_dict=full)

    det = detector(torch.bfloat16)
    det.predict_batch(images[:2])  # warm-up
    torch.cuda.synchronize()
    expected = {name: sum(site[-1] for site in sites) for name, sites in YOLO12L_SITES.items()}
    expected["c2f_fused"] = 0
    pallas.reset_launches()
    per_forward, tma = [], []
    for bsz in (2, 8, 32):  # batch 32: the benchmark cell's 8 frames four times
        before = dict(pallas.LAUNCHES)
        dets = det.predict_batch(images.repeat(4, 1, 1, 1) if bsz == 32 else images[:bsz])
        torch.cuda.synchronize()
        per_forward.append({k: pallas.LAUNCHES[k] - before[k] for k in expected})
        tma.append(pallas.LAUNCHES["conv_tma"] - before["conv_tma"])
        _require(tuple(dets.boxes.shape) == (bsz, det.max_detections, 4) and bool(torch.isfinite(dets.boxes).all()),
                 f"yolo12-l predict_batch({bsz}) malformed")
    runs = dict(pallas.LAUNCHES)
    for counts in per_forward:
        _require(counts == expected, f"yolo12-l: launches per forward {counts}, expected {expected}")
    k57 = sum(expected.values())
    _require(tma[2] >= 138, f"yolo12-l: {tma[2]} of a batch-32 forward's {k57} K5-K7 launches took the TMA-fed "
                            f"warpgroup loop, expected 138 or more")
    det32 = detector(torch.float32)
    with HeldKernels() as held:
        det.predict_batch(images[:2])
        det32.predict_batch(images[:2])
    torch.cuda.synchronize()
    _require(held.held["c2f_fused"] == 0 and sum(held.held.values()) == 2 * sum(expected.values()),
             f"yolo12-l: {held.held} launches held, expected twice {expected}")
    with torch.no_grad():
        got = det32.model(images[:2])
        want = R.Model({"variant": "l", "num_classes": 1, "reg_max": 16, "bn_eps": 1e-3}, sd).forward(
            images[:2].permute(0, 3, 1, 2))
    gap = 0.0
    for g_level, r_level in zip(got, want):
        for g, r in zip(g_level, r_level):
            r = r.double()
            gap = max(gap, float(((g.permute(0, 3, 1, 2).double() - r) ** 2).mean().sqrt() / r.std()))
    _require(gap <= 5e-3, f"yolo12-l: float32 fused head outputs {gap:.3g} of the reference's spread off")
    print(f"[8] YOLO12-L at 1024 px (seeded, fused): launches per forward {per_forward[0]} at batch 2, 8 and 32, of "
          f"them through the TMA-fed warpgroup loop {tma[0]}, {tma[1]} and {tma[2]} of {k57} K5-K7; "
          f"{sum(held.held.values())} launches of a batch-2 forward in bfloat16 and float32 at {len(held.shapes)} "
          f"distinct shapes, each within 2 bfloat16 steps (float32: 3e-4) of its plain version (largest errors "
          f"{ {k: held.worst[k] for k in HeldKernels.CONVS} }); float32 fused head outputs against the plain "
          f"reference: {gap:.3g} of its spread", flush=True)
    return runs


TICK_N = 60


def check_tick_registration(cfg) -> str:
    """Phase 10, first: K1 at the tick's shapes (B = 1, ``cfg.n_max`` source
    slots, a ``cfg.map_capacity``-slot map holding 8000 points) against its
    plain version on the same inputs (1 mm / 2e-3 rad / 1 mm), and every
    other layout that fits forced and held to the picked one's bits.  The
    plan picks its layout from these shapes, so this is the layout the
    tick's registrations launch."""
    import torch

    from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import card_plan

    dev = torch.device("cuda")
    n, cap = cfg.n_max, cfg.map_capacity
    n_map = min(8000, cap)
    one, kw, _ = k1_registration(cfg, n_map, np.random.default_rng(3))
    got, (dpos, dang, drm, it_p), _ = k1_against_plain("K1 at the tick's shapes", one, kw)
    plan = card_plan(1, n, cap, dev)
    layout = f"{plan.row_groups} x {plan.slices} {'cluster' if plan.cluster else 'grid'}"
    others = k1_layouts("K1 at the tick's shapes", one, kw, got)
    return (f"K1 at the tick's shapes ({int(one[1].sum())} live src of {n} x {n_map} live of {cap} tgt, layout "
            f"{layout}): pose err {dpos:.2g} mm / {dang:.2g} rad, rmse err {drm:.2g} mm (tol 1 mm / 2e-3 rad / 1 mm), "
            f"iters {int(got[3])} vs {it_p}; {others}")


def tick_path() -> dict:
    """Phase 10: the fused SLAM + detect tick (``BASELINE.json``
    configuration 4) on the card: ``SlamConfig(map_capacity=8192)``, seeded
    synthetic scans, the trained v12 detector in bfloat16 on the fused path,
    seeded stereo pairs.  ``TICK_N`` ticks between a reset and a reading of
    the launch counters (every kernel of the path launched), the SLAM
    quality checks, ticks/s, and a profiler window over the tick and over
    each half alone (device us, launches and the busy share); then 8 ticks
    in float32 on the card against the same ticks on the CPU (landmarks
    within 1e-3 of their value, poses within 2 mm / 2e-3 rad).  First K1 at
    the tick's shapes against its plain version (`check_tick_registration`)."""
    import torch

    import icp_slam_yolo_tpu_torch as port
    from icp_slam_yolo_tpu_torch.fusion import LandmarkMap
    from icp_slam_yolo_tpu_torch.ops import pallas

    cfg = port.SlamConfig(map_capacity=8192)
    print(f"[10] {check_tick_registration(cfg)}", flush=True)
    scans, gt = padded_sequence(TICK_N + 1, 21, cfg.n_max)
    pairs = [stereo_pair(100 + k) for k in range(TICK_N + 1)]
    det = port.detector_from_checkpoint(TICK_CHECKPOINT, conf_threshold=1e-6, pallas_convs=True)
    warm = port.Slam(cfg)
    for k in range(3):  # warm-up: CUDA context, allocator, the detector's first batch-2 forward
        tick(warm, det, LandmarkMap(), scans[k], *pairs[k])
    torch.cuda.synchronize()

    pallas.reset_launches()
    slam, landmarks = port.Slam(cfg), LandmarkMap()
    t0 = time.perf_counter()
    results = [tick(slam, det, landmarks, scans[k], *pairs[k]) for k in range(TICK_N + 1)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(pallas.LAUNCHES)
    for name in ("icp_fused", "raster_update", "nn_argmin", "conv1x1_silu", "conv3x3_silu", "conv3x3s2_silu"):
        _require(launches[name] > 0, f"the tick never launched {name}")
    _require(launches["c2f_fused"] == 0, "the v12 tick launched the C2f kernel")
    steps = [step for step, _ in results[1:]]  # the first scan starts the map
    acc = np.array([st["accepted"] for st in steps])
    rmse = np.array([st["rmse"] for st in steps])
    poses = np.array([st["pose"] for st in steps])
    pos_err, ang_err = check_quality("tick", cfg, acc, rmse, poses, gt, slam.state)
    n_fused = sum(f is not None for _, f in results)
    _require(n_fused > 0 and all(np.isfinite(lm.xy_mm).all() for lm in landmarks.landmarks),
             "tick: no finite landmark")
    print(f"[10] fused tick (SlamConfig(map_capacity=8192), {TICK_CHECKPOINT} bfloat16 fused, 640 px stereo pairs, "
          f"score threshold 1e-6): {TICK_N + 1} ticks {(TICK_N + 1) / secs:.2f} ticks/s ({secs / (TICK_N + 1) * 1e3:.2f} "
          f"ms a tick, host reads included); accepted {acc.mean():.4f}, trajectory error max {pos_err.max():.1f} mm / "
          f"{ang_err.max():.4f} rad; {n_fused} pairs fused into {len(landmarks.landmarks)} landmarks; launches "
          f"{launches}", flush=True)

    # where the device time goes: the tick, and each half alone, over n ticks of a fresh engine
    n = 20
    for what in ("tick", "slam only", "detect only"):
        s2, lm2 = port.Slam(cfg), LandmarkMap()
        s2.add_scan(scans[0])
        torch.cuda.synchronize()
        if what == "tick":
            def window():
                for k in range(1, n + 1):
                    tick(s2, det, lm2, scans[k], *pairs[k])
        elif what == "slam only":
            def window():
                for k in range(1, n + 1):
                    s2.add_scan(scans[k])
        else:
            from icp_slam_yolo_tpu_torch.fusion import fuse_stereo_pair

            def window():
                for k in range(1, n + 1):
                    fuse_stereo_pair(*det.detect_pair(*pairs[k]), s2.pose, lm2)
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        rate = n / (time.perf_counter() - t0)
        s2, lm2 = port.Slam(cfg), LandmarkMap()  # the profiled window from the same start
        s2.add_scan(scans[0])
        torch.cuda.synchronize()
        print(f"[10] {what}: {rate:.2f} a second without the profiler; profiled {n}: "
              + profile_window(torch, window, n), flush=True)

    # float32: the card's ticks against the same ticks on the CPU
    n_cmp = 8
    ends = {}
    for device in ("cuda", "cpu"):
        d32 = port.detector_from_checkpoint(TICK_CHECKPOINT, conf_threshold=1e-6, pallas_convs=True,
                                            compute_dtype=torch.float32, device=device)
        s3, lm3 = port.Slam(cfg, device=device), LandmarkMap()
        t0 = time.perf_counter()
        out = [tick(s3, d32, lm3, scans[k], *pairs[k]) for k in range(n_cmp)]
        ends[device] = (np.array([step["pose"] for step, _ in out]), lm3, time.perf_counter() - t0)
    (pc, lc, _), (pp, lp, cpu_s) = ends["cuda"], ends["cpu"]
    dpose = np.abs(pc - pp)
    _require(dpose[:, :2].max() <= 2.0 and dpose[:, 2].max() <= 2e-3, f"tick, card vs cpu: poses differ by {dpose.max(0)}")
    _require(len(lc.landmarks) == len(lp.landmarks) > 0, "tick, card vs cpu: other landmarks")
    worst = 0.0
    for a, b in zip(lc.landmarks, lp.landmarks):
        scale = max(1.0, float(np.abs(b.xy_mm).max()))
        worst = max(worst, float(np.abs(np.subtract(a.xy_mm, b.xy_mm)).max()) / scale, abs(a.yaw_rad - b.yaw_rad))
        _require((a.class_id, a.n_obs) == (b.class_id, b.n_obs), "tick, card vs cpu: landmark observations differ")
    _require(worst <= 1e-3, f"tick, card vs cpu: landmarks differ by {worst} of their value")
    print(f"[10] float32, {n_cmp} ticks on the card against the port on the CPU ({cpu_s:.1f} s there): poses within "
          f"{dpose[:, :2].max():.3g} mm / {dpose[:, 2].max():.3g} rad (tolerance 2 mm / 2e-3 rad), {len(lc.landmarks)} "
          f"landmarks within {worst:.3g} of their value (tolerance 1e-3), observations equal", flush=True)
    return launches


# ---------------------------------------------------------------- phase 11: serve

def ultralytics_layout(params: dict, stats: dict) -> dict:
    """A v8 detect checkpoint's flax tree (``params``, ``batch_stats``) ->
    the flat state dict an Ultralytics ``DetectionModel`` has (``model.``
    prefix, OIHW convs, ``.bn.*`` statistics, the head's frozen DFL conv):
    the inverse of `io.torch_import.convert_state_dict`'s mapping, written
    out here on its own so that the import is checked against it."""
    sd = {}

    def convbn(tp, p, s):
        sd[f"model.{tp}.conv.weight"] = np.asarray(p["Conv_0"]["kernel"], np.float32).transpose(3, 2, 0, 1)
        for ours, theirs, tree in (("scale", "weight", p), ("bias", "bias", p), ("mean", "running_mean", s),
                                   ("var", "running_var", s)):
            sd[f"model.{tp}.bn.{theirs}"] = np.asarray(tree["BatchNorm_0"][ours], np.float32)
        sd[f"model.{tp}.bn.num_batches_tracked"] = np.int64(0)

    def plain(tp, p):
        sd[f"model.{tp}.weight"] = np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)
        sd[f"model.{tp}.bias"] = np.asarray(p["bias"], np.float32)

    index = {"stem": 0, "down2": 1, "c2f_2": 2, "down3": 3, "c2f_3": 4, "down4": 5, "c2f_4": 6, "down5": 7,
             "c2f_5": 8, "sppf": 9, "neck_p4": 12, "neck_p3": 15, "pan_d3": 16, "pan_p4": 18, "pan_d4": 19,
             "pan_p5": 21}
    for name, i in index.items():
        p, s = params[name], stats.get(name, {})
        if "Conv_0" in p:
            convbn(i, p, s)
            continue
        convbn(f"{i}.cv1", p["ConvBnAct_0"], s["ConvBnAct_0"])
        convbn(f"{i}.cv2", p["ConvBnAct_1"], s["ConvBnAct_1"])
        b = 0
        while f"Bottleneck_{b}" in p:
            pb, sb = p[f"Bottleneck_{b}"], s[f"Bottleneck_{b}"]
            convbn(f"{i}.m.{b}.cv1", pb["ConvBnAct_0"], sb["ConvBnAct_0"])
            convbn(f"{i}.m.{b}.cv2", pb["ConvBnAct_1"], sb["ConvBnAct_1"])
            b += 1
    ph, sh = params["head"], stats["head"]
    for lvl in range(3):
        for branch, first in (("cv2", 0), ("cv3", 2)):
            for j in range(2):
                cba = f"ConvBnAct_{4 * lvl + first + j}"
                convbn(f"22.{branch}.{lvl}.{j}", ph[cba], sh[cba])
            plain(f"22.{branch}.{lvl}.2", ph[f"Conv_{2 * lvl + first // 2}"])
    sd["model.22.dfl.conv.weight"] = np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1)
    return sd


SERVE_N = 120      # scans the server replays
SERVE_LOCALIZE = 10  # scans fed (the last ones, in reverse) after the saved map is loaded back
SERVE_PAIRS = 4    # stereo pairs in the camera folder (the replay camera loops)


def jpeg_size(data: bytes) -> tuple[int, int]:
    """``(height, width)`` from a JPEG's SOF0 segment, after checking that
    it starts with SOI and ends with EOI."""
    if data[:2] != b"\xff\xd8" or data[-2:] != b"\xff\xd9":
        raise ValueError("not a complete JPEG (SOI ... EOI)")
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG marker expected at byte {pos}")
        marker = data[pos + 1]
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if marker == 0xC0:
            _, h, w = struct.unpack(">BHH", data[pos + 4:pos + 9])
            return h, w
        pos += 2 + n
    raise ValueError("JPEG without a baseline SOF0 segment")


def _http(url: str, payload=None, timeout: float = 60.0):
    """``(status, content type, body)`` of one request; a POST with a JSON body
    when ``payload`` is given."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _timed_gets(url: str, n: int) -> tuple[list, bytes]:
    times, body = [], b""
    for _ in range(n):
        t0 = time.perf_counter()
        status, _, body = _http(url)
        times.append(time.perf_counter() - t0)
        _require(status == 200, f"serve: GET {url} answered {status}")
    return times, body


def _cli(args: list, what: str) -> tuple[str, dict]:
    """The port's CLI in a subprocess (``cli.main`` with these arguments, as
    ``python -m icp_slam_yolo_tpu_torch.cli`` runs it), then that process's
    kernel launch counters.  Returns ``(stdout without the counters' line,
    counters)``."""
    import os

    code = ("import json, sys; from icp_slam_yolo_tpu_torch import cli; from icp_slam_yolo_tpu_torch.ops import pallas; "
            "cli.main(sys.argv[1:]); print('LAUNCHES ' + json.dumps(pallas.LAUNCHES))")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True, timeout=300, env=env)
    _require(r.returncode == 0, f"{what}: exit {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    lines = r.stdout.splitlines()
    _require(lines and lines[-1].startswith("LAUNCHES "), f"{what}: no launch counters printed")
    return "\n".join(lines[:-1]), json.loads(lines[-1][len("LAUNCHES "):])


def serve_path(build_s: float) -> dict:
    """Phase 11: the entry points users run, on the card.  The server
    (`serve.state.ServerState` + `serve.app`) on ``OFFLINE_CONFIG`` with
    8192 map slots (the ``serve`` and ``replay`` defaults), the trained v12
    detector in bfloat16 on the fused path attached through replayed PNG
    stereo frames: warm-up (K1-K3 and K5-K7 launched in it), a replay of
    ``SERVE_N`` seeded scans written as ``.npy`` at an unthrottled rate,
    driven over HTTP (a POI at the robot and its target fire the camera;
    the stream's ``camera_data``, the map, a tile, the ICP view, a camera
    JPEG and one MJPEG part; the map saved, loaded back and the last
    ``SERVE_LOCALIZE`` scans tracked in reverse in localization), then held against a
    direct ``Slam(cfg).run`` of the same scans (accept flags equal, poses
    within 2 mm / 2e-3 rad); ``cli replay`` and ``cli detect`` in
    subprocesses against the direct run and an in-process detector; a v8
    ``.pt`` built from ``DETECT_CHECKPOINT`` through
    ``detector_from_checkpoint(..., pallas_convs=True)`` (K5-K8) against the
    msgpack detector.  Returns the launch counts of the served path, the
    CLI replay and the ``.pt`` detector (comparison runs not counted)."""
    import os
    import shutil
    import statistics
    import tempfile
    import threading
    import urllib.request

    import torch

    import icp_slam_yolo_tpu_torch as port
    from icp_slam_yolo_tpu_torch.acquisition.camera import ReplayCamera, StereoCapture
    from icp_slam_yolo_tpu_torch.io import maps as maps_io
    from icp_slam_yolo_tpu_torch.io.checkpoint import load_checkpoint
    from icp_slam_yolo_tpu_torch.ops import pallas
    from icp_slam_yolo_tpu_torch.serve.app import make_server
    from icp_slam_yolo_tpu_torch.serve.state import ServerState
    from icp_slam_yolo_tpu_torch.utils.images import decode_png, encode_png, read_image

    cfg = port.OFFLINE_CONFIG.replace(map_capacity=8192)
    conf = 1e-6  # as phase 10: the trained weights score these frames (no pallet) near 1e-5
    counted = dict.fromkeys(pallas.LAUNCHES, 0)

    def add(counts):
        for k, v in counts.items():
            counted[k] += v

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    scan_dir, cam_dir, work = (os.path.join(tmp, d) for d in ("scans", "cams", "work"))
    for d in (scan_dir, cam_dir, work):
        os.makedirs(d)
    # 1. the inputs: scans as .npy, stereo pairs as PNG
    raw, gt = synthetic_sequence(SERVE_N, seed=31)
    for k in range(SERVE_N):
        np.save(os.path.join(scan_dir, f"Scan_data_{k + 1}.npy"), raw[k])
    frames = []
    for k in range(SERVE_PAIRS):
        left, right = stereo_pair(300 + k)
        for eye, img in ((1, left), (2, right)):
            with open(os.path.join(cam_dir, f"anh_{eye}_{k}.png"), "wb") as f:
                f.write(encode_png(img))
        frames.append(left)

    # 2. warm up and start: what a fresh `cli serve --weights --camera-dir` does, with the fused detector
    det = port.detector_from_checkpoint(TICK_CHECKPOINT, conf_threshold=conf, pallas_convs=True)
    state = ServerState(cfg, work_dir=work)
    state.attach_camera(det, StereoCapture(ReplayCamera(cam_dir, "anh_1"), ReplayCamera(cam_dir, "anh_2"),
                                           os.path.join(tmp, "captures")))
    pallas.reset_launches()
    took = state.warmup(det)
    warm = dict(pallas.LAUNCHES)
    for name in ("icp_fused", "raster_update", "nn_argmin", "conv1x1_silu", "conv3x3_silu", "conv3x3s2_silu"):
        _require(warm[name] > 0, f"serve: the warm-up never launched {name}")
    add(warm)
    print(f"[11] warm-up {took['total_s']:.2f} s (kernel load {took['build_s']:.3f} s: phase 2 built them in this "
          f"process in {build_s:.1f} s; two synthetic scans {took['slam_s']:.2f} s; detector __call__ + detect_pair "
          f"{took['detector_s']:.2f} s): a fresh server pays {build_s + took['total_s']:.1f} s before it serves; "
          f"launches {warm}", flush=True)

    outs = []
    feed = state.feed_scan

    def recording(scan):
        out = feed(scan)
        outs.append(out)
        return out

    state.feed_scan = recording
    srv = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        pallas.reset_launches()
        # the replay starts paused (/stop_stream), so that the robot stands at its start while the POI is set
        _require(_http(base + "/stop_stream")[0] == 200, "serve: /stop_stream failed")
        state.start_replay(scan_dir, 1, SERVE_N + 1, rate_hz=float("inf"))
        # 3. over HTTP: a POI at the robot, then its target: the camera fires while the robot is within 1 m
        status, _, body = _http(base + "/add_point", {})
        _require(status == 200 and json.loads(body)["status"] == "success", "serve: /add_point failed")
        status, _, body = _http(base + "/set_active_target", {"id": len(state.points_of_interest) - 1})
        _require(status == 200, f"serve: /set_active_target answered {status}")
        event, seen = None, 0
        with urllib.request.urlopen(base + "/points_stream", timeout=60) as stream:
            deadline = time.time() + 120
            while time.time() < deadline:
                line = stream.readline()
                if line.startswith(b"data: "):
                    seen += 1
                    event = json.loads(line[6:])
                    if "camera_data" in event:
                        break
        _require(event is not None and "camera_data" in event, f"serve: no camera_data on the stream in {seen} events")
        pairs_before = state._camera_worker.pairs_processed
        t0 = time.perf_counter()
        _require(_http(base + "/resume_stream")[0] == 200, "serve: /resume_stream failed")
        state._thread.join(300)
        replay_s = time.perf_counter() - t0
        _require(not state._thread.is_alive() and len(outs) == SERVE_N, f"serve: the replay fed {len(outs)} scans")
        pairs_during = state._camera_worker.pairs_processed - pairs_before
        served = dict(pallas.LAUNCHES)
        add(served)
        print(f"[11] served replay: {SERVE_N} scans in {replay_s:.2f} s, {SERVE_N / replay_s:.2f} scans/s unthrottled "
              f"(the camera firing until the robot left the POI: {pairs_during} stereo pairs detected meanwhile); "
              f"first stream event with camera_data {event['camera_data']} after {seen} events (robot at its start, "
              f"{pairs_before} pairs); launches {served}", flush=True)

        acc = np.array([o["accepted"] for o in outs[1:]])
        rmse = np.array([o["rmse"] for o in outs[1:]])
        poses = np.array([o["pose"] for o in outs[1:]])
        pos_err, _ = check_quality("serve", cfg, acc, rmse, poses, gt[:SERVE_N], state.engine.state)

        # the map and the views, decoded with the port's own PNG decoder
        map_times, body = _timed_gets(base + "/map_image", 10)
        map_bytes = len(body)
        occ_img = maps_io.occupancy_to_image(state.engine.occupancy())
        _require(np.array_equal(decode_png(body), occ_img), "serve: /map_image differs from the engine's occupancy")
        meta = json.loads(_http(base + "/map_tiles_meta")[2])
        tile_times, body = _timed_gets(base + f"/map_tiles?z={meta['zmax'] - 1}&x=1&y=1", 20)
        tile = decode_png(body)
        _require(tile.shape == (256, 256) and tile.dtype == np.uint8, "serve: malformed tile")
        native = decode_png(_http(base + f"/map_tiles?z={meta['zmax']}&x=1&y=1")[2])
        _require(np.array_equal(native, occ_img[256:512, 256:512]), "serve: a native tile differs from the map")
        icp_view = decode_png(_http(base + "/icp_image")[2])
        _require(icp_view.shape == (600, 600, 3) and (icp_view != 0).any(), "serve: malformed /icp_image")

        # the camera again, at the robot's final pose: triggered pairs a second, a JPEG and an MJPEG part
        _http(base + "/add_point", {})
        _http(base + "/set_active_target", {"id": len(state.points_of_interest) - 1})
        t_wait = time.time() + 30
        while not state.camera_trigger and time.time() < t_wait:
            time.sleep(0.01)
        before_pairs, t0 = state._camera_worker.pairs_processed, time.perf_counter()
        time.sleep(5.0)
        pairs_s = (state._camera_worker.pairs_processed - before_pairs) / (time.perf_counter() - t0)
        h, w = frames[0].shape[:2]
        status, ctype, jpeg = _http(base + "/camera_image?eye=0")
        _require(status == 200 and ctype == "image/jpeg" and jpeg_size(jpeg) == (h, w),
                 f"serve: /camera_image answered {status} {ctype}")
        with urllib.request.urlopen(base + "/camera_feed?eye=1", timeout=60) as feed_stream:
            _require(feed_stream.headers.get("Content-Type") == "multipart/x-mixed-replace; boundary=frame",
                     "serve: /camera_feed content type")
            line = feed_stream.readline()
            while not line.startswith(b"Content-Length:"):
                line = feed_stream.readline()
            n = int(line.split(b":")[1])
            feed_stream.readline()
            part = feed_stream.read(n)
        _require(jpeg_size(part) == (h, w), "serve: the MJPEG part is not a JPEG of the frame's size")
        landmarks = json.loads(_http(base + "/landmarks")[2])["landmarks"]
        _require(len(landmarks) >= 1, "serve: no landmark")
        _http(base + "/set_active_target", {"id": None})
        time.sleep(0.3)  # the trigger-sync loop clears the trigger within a poll
        served_more = dict(pallas.LAUNCHES)
        add({k: served_more[k] - served[k] for k in served})
        print(f"[11] /map_image ({occ_img.shape[1]} x {occ_img.shape[0]} PNG, {map_bytes} bytes) median "
              f"{statistics.median(map_times) * 1e3:.2f} ms (min {min(map_times) * 1e3:.2f}, max "
              f"{max(map_times) * 1e3:.2f}, 10 requests), equal to the engine's occupancy; a tile of level "
              f"{meta['zmax'] - 1} median {statistics.median(tile_times) * 1e3:.2f} ms (min {min(tile_times) * 1e3:.2f}, "
              f"max {max(tile_times) * 1e3:.2f}, 20 requests, the level cached 0.5 s); triggered pairs "
              f"{pairs_s:.2f} a second (detect_pair, fusion, two annotated JPEGs); /camera_image and one /camera_feed "
              f"part: JPEGs of {w} x {h}; {len(landmarks)} landmarks", flush=True)

        # the map saved, loaded back (localization), scans tracked against it
        status, _, _ = _http(base + "/save_map?filename=served.png")
        _require(status == 200, "serve: /save_map failed")
        n_map = int(state.engine.state.map_valid.sum())
        status, _, body = _http(base + "/load_map/served.png")
        _require(status == 200 and state.update_mode == 0 and state.engine.cfg.localization_only,
                 f"serve: /load_map answered {status}")
        # the robot walks back over the mapped path: the last scans again, last first (a frozen map only
        # holds what was mapped; ahead of the replay's end the robot would leave it)
        back = list(range(SERVE_N - 1, SERVE_N - 1 - SERVE_LOCALIZE, -1))
        before = dict(pallas.LAUNCHES)
        loc = [state.feed_scan(raw[k]) for k in back]
        add({k: pallas.LAUNCHES[k] - before[k] for k in before})
        _require(all(o["accepted"] for o in loc) and int(state.engine.state.map_valid.sum()) == n_map,
                 "serve: localization rejected a scan or changed the map")
        rel = relative_poses(gt)[back]
        loc_err = np.hypot(*(np.array([o["pose"] for o in loc])[:, :2] - rel[:, :2]).T)
        # pos_err[k - 1] is the replay's error at scan k (its first scan starts the map)
        worse = float((loc_err - pos_err[np.array(back) - 1]).max())
        _require(worse <= 100.0, f"serve: localization {worse:.1f} mm further off than the replay was")
        print(f"[11] map saved (served.png / .npy, {n_map} points) and loaded back: localization on, the last "
              f"{SERVE_LOCALIZE} scans fed back in reverse all accepted, map unchanged, position error "
              f"{loc_err.max():.1f} mm, at most {worse:.1f} mm more than the replay's at the same scans "
              f"(tolerance 100 mm)", flush=True)
    finally:
        state.stopped.set()
        srv.shutdown()
        srv.server_close()

    # where a served scan's time goes: a profiler window over scans fed through a fresh server
    prof_state = ServerState(cfg, work_dir=work)
    prof_state.feed_scan(raw[0])
    n = 20

    def window():
        for k in range(1, n + 1):
            prof_state.feed_scan(raw[k])

    torch.cuda.synchronize()
    print(f"[11] a served scan (ServerState.feed_scan), profiled {n}: " + profile_window(torch, window, n), flush=True)

    # 4. the server against a direct replay of the same scans on the card
    padded = np.zeros((SERVE_N, cfg.n_max, 3), np.float32)
    padded[:, :raw.shape[1]] = raw[:SERVE_N]
    direct = port.Slam(cfg)
    _, douts = direct.run(padded)
    d_acc = douts.accepted.cpu().numpy()
    d_pose = douts.pose.cpu().numpy()
    dp = np.abs(poses - d_pose)
    _require(np.array_equal(acc, d_acc), "serve: accept flags differ from the direct replay")
    _require(dp[:, :2].max() <= 2.0 and dp[:, 2].max() <= 2e-3, f"serve: poses differ from the direct replay by {dp.max(0)}")
    print(f"[11] server against Slam(cfg).run of the same {SERVE_N} scans: accept flags equal, poses within "
          f"{dp[:, :2].max():.3g} mm / {dp[:, 2].max():.3g} rad (tolerance 2 mm / 2e-3 rad; bit equal: "
          f"{bool(np.array_equal(poses, d_pose))})", flush=True)

    # 5. the CLI in subprocesses
    out = os.path.join(tmp, "cli_map")
    t0 = time.perf_counter()
    text, cli_launches = _cli(["replay", scan_dir, "--end", str(SERVE_N + 1), "--output", out], "cli replay")
    cli_s = time.perf_counter() - t0
    for name in ("icp_fused", "raster_update", "nn_argmin"):
        _require(cli_launches[name] > 0, f"cli replay never launched {name}")
    add(cli_launches)
    traj = np.load(out + "_trajectory.npy")
    png = decode_png(open(out + ".png", "rb").read())
    pix = np.load(out + ".npy")
    pcd = maps_io.load_pcd(out + ".pcd")
    want_traj = np.asarray(direct.trajectory)
    dt = np.abs(traj - want_traj)
    _require(traj.shape == (SERVE_N, 3) and dt[:, :2].max() <= 2.0 and dt[:, 2].max() <= 2e-3,
             f"cli replay: trajectory differs from the direct run by {dt.max(0)}")
    _require(png.shape == (cfg.map.height_px, cfg.map.width_px) and pix.dtype == np.int32 and pix.shape[1] == 2
             and pcd.shape == (len(pix), 3) and len(pix) == int(direct.state.map_valid.sum()),
             "cli replay: malformed artifacts")
    print(f"[11] cli replay ({cli_s:.1f} s in a subprocess, start-up included): {text.splitlines()[1]}; artifacts "
          f"{png.shape} PNG, {pix.shape} npy, {pcd.shape} PCD, trajectory within {dt[:, :2].max():.3g} mm / "
          f"{dt[:, 2].max():.3g} rad of the direct run (bit equal: {bool(np.array_equal(traj, want_traj))}); launches "
          f"{cli_launches}", flush=True)
    frame_paths = [os.path.join(cam_dir, f"anh_1_{k}.png") for k in range(2)]
    text, det_launches = _cli(["detect", *frame_paths, "--weights", TICK_CHECKPOINT, "--conf", str(conf)], "cli detect")
    rows = [json.loads(line) for line in text.splitlines()]
    plain_det = port.detector_from_checkpoint(TICK_CHECKPOINT, conf_threshold=conf)  # the CLI's defaults
    worst = 0.0
    for row, path in zip(rows, frame_paths):
        want = plain_det(read_image(path))
        _require(len(row["boxes"]) == len(want["boxes"]) > 0 and row["classes"] == want["classes"].tolist(),
                 f"cli detect: {path} gave other detections")
        worst = max(worst, float(np.abs(np.subtract(row["boxes"], want["boxes"])).max()),
                    float(np.abs(np.subtract(row["scores"], want["scores"])).max()))
    _require(len(rows) == 2 and worst <= 1e-3, f"cli detect: rows differ from the in-process detector by {worst}")
    print(f"[11] cli detect ({TICK_CHECKPOINT}, the CLI's defaults: bfloat16, unfused; conf {conf}): rows equal to "
          f"an in-process detector's within {worst:.3g} (tolerance 1e-3 px and score); {[len(r['boxes']) for r in rows]} "
          f"detections; launches {det_launches}", flush=True)

    # 6. a v8 .pt through detector_from_checkpoint, fused: K5-K8, against the msgpack detector
    payload, _, _ = load_checkpoint(DETECT_CHECKPOINT)
    pt_path = os.path.join(tmp, "pallet_detect_640.pt")
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in ultralytics_layout(payload["params"],
                                                                             payload["batch_stats"]).items()}, pt_path)
    pt_det = port.detector_from_checkpoint(pt_path, conf_threshold=conf, pallas_convs=True)
    ref = port.detector_from_checkpoint(DETECT_CHECKPOINT, conf_threshold=conf, pallas_convs=True)
    pallas.reset_launches()
    pt_outs = [pt_det(f) for f in frames[:3]] + list(pt_det.detect_pair(frames[0], frames[1]))
    pt_launches = dict(pallas.LAUNCHES)
    for name in DETECTOR_KERNELS:
        _require(pt_launches[name] > 0, f".pt detector never launched {name}")
    add(pt_launches)
    ref_outs = [ref(f) for f in frames[:3]] + list(ref.detect_pair(frames[0], frames[1]))
    for got, want in zip(pt_outs, ref_outs):
        _require(len(got["boxes"]) > 0 and all(np.array_equal(got[k], want[k]) for k in ("boxes", "scores", "classes")),
                 ".pt detector differs from the msgpack detector")
    print(f"[11] {DETECT_CHECKPOINT} as an Ultralytics-layout .pt (plain state dict, torch.save) through "
          f"detector_from_checkpoint(pallas_convs=True): detections on 3 frames and a stereo pair bit-equal to the "
          f"msgpack detector's; launches {pt_launches}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return counted


# ---------------------------------------------------------------- training (phase 12)

TRAIN_STEPS = 60  # the recipe's steps on the card
TRAIN_WINDOW = (40, 5)  # the recipe's profiled steps: the first and how many


class _StepTimer:
    """A `torch_train_pallet.run` step hook: each step between two
    synchronisations on the host clock, a profiler window over ``window`` =
    (first step, steps), and steps 2-4 under PyTorch's sync debug mode (a
    step must not wait for the card: its metrics stay on the device)."""

    SYNC_CHECKED = range(2, 5)

    def __init__(self, torch, window):
        self.torch, self.window = torch, window
        self.ms, self.summary = [], None

    def __call__(self, i, take_step):
        from torch.profiler import ProfilerActivity, profile

        from icp_slam_yolo_tpu_torch.ops import pallas

        torch = self.torch
        first, n = self.window
        if i == first:
            self.before = dict(pallas.LAUNCHES)
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            torch.cuda._sleep(20_000_000)  # the tracer misses its first milliseconds (`_traced`)
            torch.cuda.synchronize()
            self.t_window = time.perf_counter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i in self.SYNC_CHECKED:
            torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = take_step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        if i == first + n - 1:
            wall = time.perf_counter() - self.t_window
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.summary = window_summary(torch, self.prof, wall, n, self.before)
        return metrics


def _recipe_args(root: str, out: str, **kw):
    import argparse

    args = dict(data=root, img_size=640, batch_size=16, steps=TRAIN_STEPS, eval_images=16, eval_every=0,
                target_map50=0.99, family="v8", dtype="bfloat16", no_scale_aug=False, out=out, device=None)
    args.update(kw)
    return argparse.Namespace(**args)


def _train_card_against_cpu(root: str, family: str, task: str, labels: str) -> str:
    """One float32 train step at 64 px, batch 2, on the card (cuDNN, TF32
    off) and on the CPU from one initial state and one batch: the loss, each
    gradient leaf, each updated parameter and each running statistic.
    Returns a summary; raises beyond the tolerances."""
    import torch

    from icp_slam_yolo_tpu_torch.io.yolo_data import DeviceYoloDataset, find_pairs
    from icp_slam_yolo_tpu_torch.models.train import TrainState, create_train_state, make_optimizer, make_train_step
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO

    pairs = find_pairs(f"{root}/train/images", label_root=f"{root}/train/{labels}")
    ds = DeviceYoloDataset("", img_size=64, batch_size=2, max_gt=16, task=task, pairs=pairs, device="cpu")
    batch_cpu = next(iter(ds))
    sides = {}
    for dev in ("cpu", "cuda"):
        model = YOLO(num_classes=1, family=family, task=task)
        create_train_state(model, 64, seed=5, device="cpu")
        model.to(dev)
        state = TrainState(model, make_optimizer(model, total_steps=10))
        p0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        grads = {}
        update = state.optimizer.step

        def keep_grads_then_update(model=model, update=update):  # the unclipped gradients
            grads.update({n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()})
            return update()

        state.optimizer.step = keep_grads_then_update
        step = make_train_step(model, state.optimizer, 64)
        _, metrics = step(state, {k: v.to(dev) for k, v in batch_cpu.items()})
        sides[dev] = (float(metrics["loss"]), grads, p0, {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (loss_c, g_c, p0, s_c), (loss_g, g_g, _, s_g) = sides["cpu"], sides["cuda"]
    loss_err = abs(loss_g / loss_c - 1.0)
    # a leaf whose gradient cancels to rounding noise (the v11 attention blocks' bare BatchNorm biases: ~1e-21
    # in a float64 run) is held to 1e-5 of the whole gradient's norm instead
    floor = 1e-5 * float(torch.sqrt(sum((g * g).sum() for g in g_c.values())))
    grad_err = max(float((g_g[n] - g_c[n]).norm() / (g_c[n].norm() + floor)) for n in g_c)
    big_grad = [n for n in g_c if float((g_g[n] - g_c[n]).norm()) > 2e-2 * float(g_c[n].norm()) + floor]
    param_err, stat_err = 0.0, 0.0
    for k, after in s_c.items():
        if k.endswith("num_batches_tracked"):
            continue
        e = float((s_g[k] - after).norm())
        if k.endswith(("running_mean", "running_var")):
            stat_err = max(stat_err, e / float(after.norm()))
            _require(e <= 2e-3 * float(after.norm()), f"card vs cpu train step ({family} {task}): statistic {k} off by {e}")
        else:
            bound = 1e-3 * float(after.norm()) + 0.05 * float((after - p0[k]).norm()) + 1e-9
            param_err = max(param_err, e / bound)
            _require(e <= bound, f"card vs cpu train step ({family} {task}): parameter {k} off by {e} (bound {bound})")
    _require(loss_err <= 1e-4 and not big_grad,
             f"card vs cpu train step ({family} {task}): loss {loss_g} vs {loss_c}; gradients beyond 2e-2: {big_grad[:5]}")
    return (f"{family} {task}: loss {loss_g:.6f} (card) vs {loss_c:.6f} (cpu), relative {loss_err:.2e} (tolerance 1e-4); "
            f"gradient leaves within {grad_err:.2e} of their norm (tolerance 2e-2, + 1e-5 of the whole gradient's norm); "
            f"parameters after the update at most {param_err:.2f} of their bound (1e-3 of the norm + 5e-2 of the update "
            f"+ 1e-9); running "
            f"statistics within {stat_err:.2e} (tolerance 2e-3)")


TASK_STEPS = 3  # each task script's steps on the card


def _held_summary(held) -> str:
    _require(all(held.held[k] > 0 for k in held.held), f"an evaluation did not launch every K5-K8: {held.held}")
    return (f"{sum(held.held.values())} K5-K8 launches each held against its plain version {held.held}, largest errors "
            f"{ {k: float(f'{v:.4g}') for k, v in held.worst.items()} }")


def task_scripts(root: str, tmp: str) -> None:
    """The task scripts (`scripts/torch_train_{obb,segment,pose}.py`, their
    defaults: v8, 640 px) for ``TASK_STEPS`` steps each on `pallet_dataset`'s
    frames (symlinked into the layouts they read), every loss finite; each
    trained checkpoint evaluated through a fused `Detector` (bfloat16, its
    default: K5-K8), every K5-K8 launch held against its plain version: the
    obb one by `evaluate_obb_detector`, the segment one's masks on the val
    frames (besides the script's own unfolded float32 mask IoU), the pose
    one by the script's own evaluation."""
    import os

    import icp_slam_yolo_tpu_torch as port
    import torch_train_obb
    import torch_train_pose
    import torch_train_segment
    from icp_slam_yolo_tpu_torch.io.checkpoint import load_checkpoint
    from icp_slam_yolo_tpu_torch.io.yolo_data import find_pairs
    from icp_slam_yolo_tpu_torch.models.eval import evaluate_obb_detector
    from icp_slam_yolo_tpu_torch.utils.images import read_image, to_rgb

    poly = os.path.join(root, "poly")  # obb and segment: <data>/{training,val}/{images,labels} of polygons
    for split, src in (("training", "train"), ("val", "val")):
        os.makedirs(os.path.join(poly, split), exist_ok=True)
        os.symlink(os.path.join(root, src, "images"), os.path.join(poly, split, "images"))
        os.symlink(os.path.join(root, src, "labels_poly"), os.path.join(poly, split, "labels"))

    def losses(hist, what):
        vals = [h["loss"] for h in hist]
        _require(len(vals) == TASK_STEPS and np.isfinite(vals).all(), f"{what}: a loss is not finite")
        return [round(v, 3) for v in vals]

    def fused(ckpt, task):
        payload, _, meta = load_checkpoint(ckpt)
        return port.Detector(num_classes=1, task=task, family=meta.get("family", "v8"), img_size=meta["img_size"],
                             conf_threshold=0.001, params=payload)

    steps = ["--steps", str(TASK_STEPS)]
    t0 = time.perf_counter()
    out = torch_train_obb.run(torch_train_obb.parse_args(["--data", poly, "--out", os.path.join(tmp, "obb"), *steps]))
    train_s = time.perf_counter() - t0
    with HeldKernels() as held:
        ev = evaluate_obb_detector(fused(out["checkpoint"], "obb"), os.path.join(poly, "val"), max_images=8)
    print(f"[12] torch_train_obb.run (v8, 640 px, batch 8, float32): losses {losses(out['history'], 'obb')}, "
          f"{train_s:.1f} s with the dataset's upload; evaluate_obb_detector through the fused bfloat16 detector on 8 "
          f"val frames: { {k: v for k, v in ev.items() if not isinstance(v, list)} }; {_held_summary(held)}", flush=True)

    t0 = time.perf_counter()
    m = torch_train_segment.run(torch_train_segment.parse_args(["--data", poly, "--out", os.path.join(tmp, "seg"),
                                                                *steps]))
    train_s = time.perf_counter() - t0
    det = fused(os.path.join(tmp, "seg"), "segment")
    frames = [to_rgb(read_image(ip)) for ip, _ in find_pairs(os.path.join(poly, "val"))[:8]]
    with HeldKernels() as held:
        masks = [det(f)["masks"] for f in frames]
    _require(all(mk.ndim == 3 and mk.shape[1:] == (160, 160) and np.isfinite(mk).all() for mk in masks),
             "segment: masks of the fused detector")
    print(f"[12] torch_train_segment.run (v8, 640 px, batch 8, bfloat16): losses {losses(m['history'], 'segment')}, "
          f"{train_s:.1f} s with its evaluation (unfolded float32): mask IoU mean {m['mask_iou_mean']}, n_val "
          f"{m['n_val']}; the fused bfloat16 detector on 8 val frames: {sum(len(mk) for mk in masks)} masks of 160 x "
          f"160; {_held_summary(held)}", flush=True)

    t0 = time.perf_counter()
    with HeldKernels() as held:  # its evaluation builds the pose `Detector` (the kernels by default)
        m = torch_train_pose.run(torch_train_pose.parse_args(
            ["--images", os.path.join(root, "train", "images"), "--labels", os.path.join(root, "train", "labels_pose"),
             "--out", os.path.join(tmp, "pose"), *steps]))
    print(f"[12] torch_train_pose.run (v8, 640 px, batch 16, float32, 80/20 split): losses "
          f"{losses(m['history'], 'pose')}, {time.perf_counter() - t0:.1f} s with its evaluation through the fused "
          f"bfloat16 detector: { {k: v for k, v in m.items() if k != 'history'} }; {_held_summary(held)}", flush=True)


def train_path() -> dict:
    """Phase 12: training and evaluation of the pallet detector on the card.
    A seeded synthetic dataset (`pallet_dataset`: 48 + 16 PNG frames of 480
    x 640, 1-3 pallets each, box, polygon and pose labels); one float32 step
    at 64 px, batch 2, card against CPU (v8 detect, v11 obb); the recipe
    (`scripts/torch_train_pallet.run`: yolo-n v8, 640 px, batch 16, bfloat16
    compute, zoom-out and flips, the dataset on the card) for
    ``TRAIN_STEPS`` steps, each timed, a profiler window, the loss required
    to fall, then 10 float32 steps; the trained checkpoint through the fused
    detector (K5-K8 launches a forward, each held against its plain
    version, fused against unfused, `evaluate_detector` on ``val/``); v12
    detect and v11 obb (5 steps) and v8 segment and pose (3 steps) at 640 px,
    batch 16, bfloat16; the task scripts (`task_scripts`); ``cli train`` and
    ``cli eval`` in subprocesses.
    Returns the launch counts of the run (counters zeroed at its start)."""
    import os
    import shutil
    import tempfile

    import torch

    import icp_slam_yolo_tpu_torch as port
    from icp_slam_yolo_tpu_torch.io.yolo_data import DeviceYoloDataset, find_pairs
    from icp_slam_yolo_tpu_torch.models.eval import evaluate_detector
    from icp_slam_yolo_tpu_torch.models.train import create_train_state, make_train_step
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO
    from icp_slam_yolo_tpu_torch.ops import pallas

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import torch_train_pallet

    t_phase = time.perf_counter()
    pallas.reset_launches()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    root = os.path.join(tmp, "pallets")
    t0 = time.perf_counter()
    pallet_dataset(root, seed=12)
    print(f"[12] dataset: 48 train + 16 val PNG frames of 480 x 640 written in {time.perf_counter() - t0:.1f} s", flush=True)

    # 2. one float32 step, card against CPU
    for family, task, labels in (("v8", "detect", "labels"), ("v11", "obb", "labels_poly")):
        print("[12] float32 train step at 64 px, batch 2, card vs cpu, " + _train_card_against_cpu(root, family, task, labels),
              flush=True)

    # 3. the recipe at full width
    torch.cuda.reset_peak_memory_stats()
    timer = _StepTimer(torch, TRAIN_WINDOW)
    metrics = torch_train_pallet.run(_recipe_args(root, os.path.join(tmp, "pallet")), step_hook=timer)
    peak = torch.cuda.max_memory_allocated() / 2**30
    hist = metrics.pop("history")
    losses = np.array([h["loss"] for h in hist])
    norms = np.array([h["grad_norm"] for h in hist])
    _require(len(hist) == TRAIN_STEPS and np.isfinite(losses).all() and np.isfinite(norms).all(),
             "recipe: a loss or gradient norm is not finite")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    _require(last < first, f"recipe: the loss did not fall (first 10 steps {first:.4f}, last 10 {last:.4f})")
    med = float(np.median(timer.ms[1:]))
    print(f"[12] torch_train_pallet.run: yolo-n v8, 640 px, batch 16, bfloat16 compute (float32 parameters), zoom-out "
          f"and flips, {TRAIN_STEPS} steps: loss mean of steps 1-10 {first:.4f} -> steps {TRAIN_STEPS - 9}-{TRAIN_STEPS} "
          f"{last:.4f}, every loss and gradient norm finite (last grad_norm {norms[-1]:.3f}, num_fg {hist[-1]['num_fg']:.0f}), "
          f"steps 3-5 under the sync debug mode; "
          f"step wall (synchronised) median {med:.2f} ms (first step {timer.ms[0]:.1f} ms), {16e3 / med:.1f} images/s; "
          f"peak memory {peak:.2f} GiB; val (16 frames, conf 0.001, the fused bfloat16 detector): "
          f"mAP50 {metrics['mAP50']:.4f}, mAP50-95 {metrics['mAP50_95']:.4f}", flush=True)
    print(f"[12] recipe steps {TRAIN_WINDOW[0] + 1}-{sum(TRAIN_WINDOW)}, profiled: {timer.summary}", flush=True)

    timer32 = _StepTimer(torch, (4, 5))
    m32 = torch_train_pallet.run(_recipe_args(root, os.path.join(tmp, "pallet_f32"), dtype="float32", steps=10,
                                              eval_images=2), step_hook=timer32)
    h32 = m32.pop("history")
    _require(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in h32), "float32 recipe: not finite")
    med32 = float(np.median(timer32.ms[1:]))
    print(f"[12] the same in float32 (the CLI's type), 10 steps: step wall median {med32:.2f} ms, {16e3 / med32:.1f} "
          f"images/s; steps 5-9 profiled: {timer32.summary}", flush=True)

    # 4. the trained checkpoint through the fused detector
    ckpt = os.path.join(tmp, "pallet")
    fused = port.detector_from_checkpoint(ckpt, conf_threshold=0.001, pallas_convs=True)
    unfused = port.detector_from_checkpoint(ckpt, conf_threshold=0.001, pallas_convs=False)
    full = port.detector_from_checkpoint(ckpt, conf_threshold=0.001, pallas_convs=True, compute_dtype=torch.float32)
    frames = [pallet_image(np.random.default_rng(1200 + k))[0] for k in range(8)]
    batch8 = np.concatenate([fused.preprocess(f)[0] for f in frames])
    per_forward = []

    def counted(fn):
        before = dict(pallas.LAUNCHES)
        out = fn()
        per_forward.append({k: pallas.LAUNCHES[k] - before[k] for k in LAUNCHES_PER_FORWARD})
        return out

    with HeldKernels() as held:
        counted(lambda: fused(frames[0]))
        counted(lambda: fused.detect_pair(frames[1], frames[2]))
        counted(lambda: fused.predict_batch(batch8))
        counted(lambda: full.predict_batch(batch8[:2]))
    for counts in per_forward:
        _require(counts == LAUNCHES_PER_FORWARD, f"trained detector: launches per forward {counts}")
    images = torch.from_numpy(batch8[:2]).cuda()
    with torch.no_grad():
        heads = [_head_tensors(d.model(images)) for d in (fused, unfused, full)]
    worst_fu, worst_f, worst_u, mag = 0.0, 0.0, 0.0, 0.0
    for a, b, c in zip(*heads):
        worst_fu = max(worst_fu, float((a.float() - b.float()).abs().max()))
        worst_f = max(worst_f, float((a.float() - c).abs().max()))
        worst_u = max(worst_u, float((b.float() - c).abs().max()))
        mag = max(mag, float(c.abs().max()))
    tol = 0.04 * mag  # phase 8's
    _require(worst_fu <= tol and worst_f <= max(2.0 * worst_u, tol / 2), "trained detector: fused and unfused differ")
    ev = evaluate_detector(fused, os.path.join(root, "val"), 640, conf_threshold=0.001)
    print(f"[12] the trained checkpoint through detector_from_checkpoint(pallas_convs=True), bfloat16 and float32: "
          f"launches per forward {per_forward[0]} at batch 1, 2, 8 (and float32 batch 2); {sum(held.held.values())} K5-K8 "
          f"launches each held against its plain version (2 bfloat16 steps, K8 4; float32 3e-4), largest errors "
          f"{ {k: float(f'{v:.4g}') for k, v in held.worst.items()} }; head outputs at batch 2: fused vs unfused "
          f"{worst_fu:.4g} (tolerance {tol:.4g}), against float32 fused {worst_f:.4g}, unfused {worst_u:.4g}; "
          f"evaluate_detector on val/ (16 frames, conf 0.001): mAP50 {ev['mAP50']:.4f}, mAP50-95 {ev['mAP50_95']:.4f}, "
          f"P {ev['precision']:.4f}, R {ev['recall']:.4f} (reported, not gated: {TRAIN_STEPS} steps from scratch)",
          flush=True)

    # 5. the reference's other families at full width, with device augmentation (the task scripts follow)
    for family, task, labels, steps in (("v12", "detect", "labels", 5), ("v11", "obb", "labels_poly", 5),
                                        ("v8", "segment", "labels_poly", 3), ("v8", "pose", "labels_pose", 3)):
        pairs = find_pairs(f"{root}/train/images", label_root=f"{root}/train/{labels}")
        ds = DeviceYoloDataset("", img_size=640, batch_size=16, max_gt=16, augment=True, task=task, pairs=pairs,
                               scale_aug=(0.5, 0.67, 0.83, 1.0))
        model = YOLO(num_classes=1, family=family, task=task, compute_dtype=torch.bfloat16)
        state = create_train_state(model, 640, total_steps=steps)
        step = make_train_step(model, state.optimizer, 640)
        it, ms, hist = iter(ds), [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, next(it))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            hist.append({k: float(v) for k, v in m.items()})
        _require(all(np.isfinite(list(h.values())).all() for h in hist), f"{family} {task}: a loss is not finite")
        print(f"[12] {family} {task}, 640 px, batch 16, bfloat16, {steps} steps: losses "
              f"{[round(h['loss'], 3) for h in hist]}, last terms { {k: round(v, 4) for k, v in hist[-1].items()} }; "
              f"step wall {ms[-1]:.1f} ms (first {ms[0]:.0f} ms)", flush=True)

    # 6. the task scripts, each evaluated through the hand-written kernels
    task_scripts(root, tmp)

    # 7. the command line in subprocesses
    cli_ckpt = os.path.join(tmp, "cli_ckpt")
    t0 = time.perf_counter()
    out, _ = _cli(["train", os.path.join(root, "train"), "--steps", "4", "--output", cli_ckpt], "cli train")
    train_s = time.perf_counter() - t0
    _require(os.path.exists(cli_ckpt) and os.path.exists(cli_ckpt + ".results.csv") and "step 1/4" in out,
             "cli train: no checkpoint or log")
    t0 = time.perf_counter()
    out, _ = _cli(["eval", "--weights", cli_ckpt, "--data", os.path.join(root, "val")], "cli eval")
    got = json.loads(out)
    _require(got.get("task") == "detect" and "mAP50" in got, f"cli eval: {got}")
    print(f"[12] cli train (float32, 640 px, batch 16, 4 steps) in a subprocess {train_s:.1f} s, then cli eval on its "
          f"checkpoint {time.perf_counter() - t0:.1f} s: {got}", flush=True)
    launches = dict(pallas.LAUNCHES)
    for name in DETECTOR_KERNELS:
        _require(launches[name] > 0, f"phase 12 never launched {name}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[12] phase 12 in {time.perf_counter() - t_phase:.1f} s; launches {launches}", flush=True)
    return launches


# ---------------------------------------------------------------- phase 13: JPEG decoding and the labeling path

JPEG_FIXTURES = "tests/data/torch_jpeg"  # written with PIL by scripts/torch_jpeg_fixtures.py
LABEL_FRAMES = 8
LABEL_SEGMENT_INSTANCES = 4


def _median_ms(fn, n: int = 10) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def check_jpeg_fixtures() -> str:
    """Phase 13 (1-2): decode the committed JPEG fixtures and hold each array
    to the digest of PIL's pixels committed beside it (this machine has no
    PIL); then the decode times of 480 x 640 frames, median of 10."""
    import hashlib
    import os

    from icp_slam_yolo_tpu_torch.utils.images import decode_jpeg, encode_jpeg

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), JPEG_FIXTURES)
    with open(os.path.join(root, "pixels.json")) as f:
        want = json.load(f)
    for name, entry in want.items():
        with open(os.path.join(root, name), "rb") as f:
            arr = decode_jpeg(f.read())
        got = hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()
        _require(list(arr.shape) == entry["shape"] and got == entry["sha256"],
                 f"jpeg fixture {name}: decoded {arr.shape} {got}, PIL's {entry['shape']} {entry['sha256']}")
    frames = {"synthetic_frame": synthetic_frame(0), "pallet_image": pallet_image(np.random.default_rng(0))[0]}
    times = {}
    for what, frame in frames.items():
        data = encode_jpeg(frame, quality=95)
        times[f"{what} baseline q95 4:2:0 ({len(data)} bytes)"] = _median_ms(lambda d=data: decode_jpeg(d))
    for name in sorted(want):
        if want[name]["shape"][:2] == [480, 640]:
            with open(os.path.join(root, name), "rb") as f:
                data = f.read()
            times[f"{name} ({len(data)} bytes)"] = _median_ms(lambda d=data: decode_jpeg(d))
    return (f"{len(want)} fixtures decoded to PIL's digests; decode ms a 480 x 640 frame (median of 10): "
            + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))


def _cli_in_process(args: list) -> tuple[int, str]:
    """``cli.main(args)`` in this process: its exit code and standard output."""
    import contextlib
    import io

    from icp_slam_yolo_tpu_torch import cli

    out, code = io.StringIO(), 0
    with contextlib.redirect_stdout(out):
        try:
            cli.main(args)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    return code, out.getvalue()


def _boxes_match(a: dict, b: dict, conf: float, tol: float = 0.05) -> str:
    """Two detectors' outputs on one frame: every box of each side has one on
    the other within ``tol`` pixels (but those scored at the threshold)."""
    worst, n = 0.0, 0
    for mine, other in ((a, b), (b, a)):
        for box, score in zip(mine["boxes"], mine["scores"]):
            if abs(float(score) - conf) <= 2e-3 * conf:
                continue
            d = np.abs(other["boxes"] - box).max(axis=1) if len(other["boxes"]) else np.array([np.inf])
            worst = max(worst, float(d.min()))
            n += 1
    _require(n > 0 and worst <= tol, f"float32 auto-label polygons, card vs cpu: {worst} px apart (tolerance {tol})")
    return f"{n // 2} polygons on both sides within {worst:.3g} px (tolerance {tol})"


def label_path() -> dict:
    """Phase 13: JPEG decoding and the dataset-labeling toolchain on the card.
    Returns the labeling path's launch counts (the run between the counters'
    reset and their reading)."""
    import os
    import shutil
    import tempfile
    import threading

    import torch

    import icp_slam_yolo_tpu_torch as port
    from icp_slam_yolo_tpu_torch.data.labeler import LabelSession
    from icp_slam_yolo_tpu_torch.models.eval import evaluate_detector
    from icp_slam_yolo_tpu_torch.ops import pallas
    from http.server import ThreadingHTTPServer

    from icp_slam_yolo_tpu_torch.serve.labeler_app import make_labeler_handler
    from icp_slam_yolo_tpu_torch.utils.images import encode_jpeg, read_image

    t_phase = time.perf_counter()
    print("[13] " + check_jpeg_fixtures(), flush=True)
    conf = 1e-6  # phase 8's threshold: the trained weights score these frames far below 0.5
    tmp = tempfile.mkdtemp(prefix="chip_smoke_label_")
    try:
        frames_dir, out_dir = os.path.join(tmp, "frames"), os.path.join(tmp, "labels")
        os.makedirs(frames_dir)
        rng = np.random.default_rng(13)
        for i in range(LABEL_FRAMES):
            with open(os.path.join(frames_dir, f"pallet_{i}.jpg"), "wb") as f:
                f.write(encode_jpeg(pallet_image(rng)[0], quality=95))
        session = LabelSession(frames_dir, out_dir)
        det = port.detector_from_checkpoint(DETECT_CHECKPOINT, conf_threshold=conf, pallas_convs=True)
        det(read_image(session.images[0]))  # warm-up
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_labeler_handler(session, det))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            torch.cuda.synchronize()
            # -- the main path: counters zeroed just before, read just after
            pallas.reset_launches()
            per_label, added, auto_s = [], [], 0.0
            for i in range(LABEL_FRAMES):
                before = dict(pallas.LAUNCHES)
                t0 = time.perf_counter()
                status, _, body = _http(base + "/label/auto", {})
                auto_s += time.perf_counter() - t0
                _require(status == 200, f"/label/auto answered {status}: {body[:200]!r}")
                per_label.append({k: pallas.LAUNCHES[k] - before[k] for k in LAUNCHES_PER_FORWARD})
                added.append(json.loads(body)["added"])
                status, _, body = _http(base + "/label/save", {})
                _require(status == 200 and json.loads(body)["saved"] == added[-1], f"/label/save: {body[:200]!r}")
                status, _, body = _http(base + "/label/nav", {"dir": 1})
                _require(status == 200 and json.loads(body)["ok"], f"/label/nav: {body[:200]!r}")
            obb_dir = os.path.join(out_dir, "output")
            # label-check: a box that crosses the frame's edge is out of range, and --fix clamps it
            bad = 0
            for name in os.listdir(obb_dir):
                with open(os.path.join(obb_dir, name)) as f:
                    bad += any(not 0.0 <= float(v) <= 1.0 for line in f for v in line.split()[1:])
            code, text = _cli_in_process(["label-check", obb_dir])
            _require(code == (1 if bad else 0) and f"checked {LABEL_FRAMES} files: {bad} with" in text,
                     f"cli label-check: exit {code}, {text[-300:]!r}, expected {bad} bad files")
            if bad:
                code, _ = _cli_in_process(["label-check", obb_dir, "--fix"])
                _require(code == 0, "cli label-check --fix did not exit 0")
                code, text = _cli_in_process(["label-check", obb_dir])
                _require(code == 0, f"cli label-check after --fix: exit {code}, {text[-300:]!r}")
            pool = os.path.join(tmp, "pool")
            shutil.copytree(frames_dir, os.path.join(pool, "images"))
            shutil.copytree(os.path.join(out_dir, "output_oject"), os.path.join(pool, "labels"))
            split_dir = os.path.join(tmp, "split")
            code, text = _cli_in_process(["split", pool, split_dir])
            n_train = int(LABEL_FRAMES * 0.8)
            _require(code == 0 and f"-> {n_train} train / {LABEL_FRAMES - n_train} val" in text, f"cli split: {text!r}")
            t0 = time.perf_counter()
            # at the auto-label threshold: the labels are this detector's own boxes, so AP must be high
            metrics = evaluate_detector(det, os.path.join(split_dir, "val"), 640, conf_threshold=conf)
            eval_s = time.perf_counter() - t0
            _require(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics.values() if isinstance(v, float))
                     and metrics["mAP50"] >= 0.5, f"evaluate on the split's val set: {metrics}")
            seg = port.detector_from_checkpoint(SEGMENT_CHECKPOINT, conf_threshold=conf, pallas_convs=True)
            before = dict(pallas.LAUNCHES)
            n_seg = session.auto_label_segment(seg.model, 640, conf_threshold=conf, max_instances=LABEL_SEGMENT_INSTANCES)
            seg_launches = {k: pallas.LAUNCHES[k] - before[k] for k in LAUNCHES_PER_FORWARD}
            torch.cuda.synchronize()
            launches = dict(pallas.LAUNCHES)
        finally:
            server.shutdown()
            server.server_close()
        for counts in per_label:
            _require(counts == LAUNCHES_PER_FORWARD, f"auto-label: launches a frame {counts}, expected {LAUNCHES_PER_FORWARD}")
        _require(min(added) > 0, f"auto-label: polygons a frame {added}")
        _require(0 < n_seg <= LABEL_SEGMENT_INSTANCES and all(seg_launches.values()),
                 f"auto_label_segment: {n_seg} polygons, launches {seg_launches}")
        for sub in ("output", "output_pose", "output_oject"):
            _require(len(os.listdir(os.path.join(out_dir, sub))) == LABEL_FRAMES, f"labels: {sub} incomplete")
        print(f"[13] labeling path: {LABEL_FRAMES} pallet_image frames as q95 JPEG, LabelSession + serve_labeler "
              f"in process, detector_from_checkpoint({DETECT_CHECKPOINT!r}, pallas_convs=True) bfloat16 at 640 px, "
              f"conf {conf}: POST /label/auto {LABEL_FRAMES / auto_s:.2f} auto-labels/s ({auto_s / LABEL_FRAMES * 1e3:.1f} "
              f"ms each: the JPEG decode, the forward and NMS, HTTP), polygons a frame {added}, launches a frame "
              f"{per_label[0]}; /label/save wrote the three formats and kiem_tra.csv; cli label-check "
              f"({bad} files with a box past the frame's edge{', fixed by --fix' if bad else ''}) exit 0; cli split "
              f"{n_train} / {LABEL_FRAMES - n_train}; evaluate on val/ ({eval_s:.2f} s): "
              f"{ {k: round(v, 4) for k, v in metrics.items() if isinstance(v, float)} }; auto_label_segment "
              f"({SEGMENT_CHECKPOINT}, fused) {n_seg} polygons, launches {seg_launches}; launches {launches}", flush=True)

        # -- cli detect on one JPEG against an in-process detector built the same way (unfused, bfloat16)
        jpg = session.images[0]
        code, text = _cli_in_process(["detect", jpg, "--weights", DETECT_CHECKPOINT, "--conf", str(conf)])
        _require(code == 0, f"cli detect: exit {code}")
        row = json.loads(text.strip().splitlines()[-1])
        want = port.detector_from_checkpoint(DETECT_CHECKPOINT, conf_threshold=conf)(read_image(jpg))
        _require(row["image"] == jpg and len(row["boxes"]) == len(want["boxes"]) > 0
                 and np.allclose(row["boxes"], want["boxes"], atol=1e-3), "cli detect on a JPEG differs")

        # -- every K5-K8 launch of an auto-label held against its plain version (phase 7's shims)
        held_session = LabelSession(frames_dir, os.path.join(tmp, "held"))
        with HeldKernels() as held:
            for i in range(LABEL_FRAMES):
                held_session.index = i
                held_session.auto_label(det)
        torch.cuda.synchronize()
        _require(held.held == {k: v * LABEL_FRAMES for k, v in LAUNCHES_PER_FORWARD.items()},
                 f"held launches {held.held}")
        # ... and the segment forward's (its proto and mask-coefficient convs too), on the same frame
        held_seg_session = LabelSession(frames_dir, os.path.join(tmp, "held_seg"))
        held_seg_session.index = session.index
        with HeldKernels() as held_seg:
            n_seg_held = held_seg_session.auto_label_segment(seg.model, 640, conf_threshold=conf,
                                                             max_instances=LABEL_SEGMENT_INSTANCES)
        torch.cuda.synchronize()
        _require(held_seg.held == seg_launches and n_seg_held == n_seg,
                 f"held segment launches {held_seg.held} ({n_seg_held} polygons), counted {seg_launches} ({n_seg})")

        # -- float32: the card's auto-label polygons against the port's on the CPU
        full = port.detector_from_checkpoint(DETECT_CHECKPOINT, conf_threshold=conf, pallas_convs=True,
                                             compute_dtype=torch.float32)
        cpu = port.detector_from_checkpoint(DETECT_CHECKPOINT, conf_threshold=conf, pallas_convs=True,
                                            compute_dtype=torch.float32, device="cpu")
        sides = []
        for d in (full, cpu):
            s, seen = LabelSession(frames_dir, os.path.join(tmp, f"f32_{d.device.type}")), []
            s.auto_label(lambda img, d=d: seen.append(d(img)) or seen[-1])
            polygons = np.array([p.bbox() for p in s.current], np.float64).reshape(-1, 4)
            _require(np.array_equal(polygons, seen[0]["boxes"].astype(np.float64)), "auto-label polygons are not the detections")
            sides.append({"boxes": polygons, "scores": seen[0]["scores"]})
        summary = _boxes_match(sides[0], sides[1], conf)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[13] every auto-label launch held against its plain version ({sum(held.held.values())} launches, largest "
          f"errors {held.worst}; the segment forward's {sum(held_seg.held.values())}, largest errors "
          f"{held_seg.worst}); float32 auto-label, card vs cpu: {summary}; cli detect on a JPEG equal to the "
          f"in-process detector; phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------- phase 16: cli bench

# the JSON line's keys, as the root ``bench.py`` prints them (`bench.py:533-637`), and the port's own
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "secondary", "protocol", "data", "device")
BENCH_READINGS = (
    "single_pair_latency_ms", "single_pair_fixed50_ms", "sequence_scans_per_sec",
    "sequence_scans_per_sec_offline_preset", "sequence_scans_per_sec_realtime_preset", "detect_fps_640",
    "detect_gflop_per_image", "detect_achieved_tflops", "detect_mfu", "detect_fps_640_b128", "detect_mfu_b128",
    "fleet_scans_per_sec", "fleet_matched_single_scans_per_sec", "fused_ticks_per_sec",
    "fused_ticks_per_sec_triggered", "fused_slam_only_ticks_per_sec", "fused_detect_b2_only_ticks_per_sec",
    "train_steps_per_sec_b16_640", "train_steps_per_sec_f32_b16_640", "baseline_cpu_reg_per_sec",
)
BENCH_KERNELS = ("icp_fused", "raster_update", "nn_argmin", "raster_update_grid", "conv1x1_silu", "conv3x3_silu",
                 "conv3x3s2_silu", "c2f_fused")


def _bench_numbers(line: dict) -> dict:
    """The line's readings as numbers: the headline, ``vs_baseline`` and every
    secondary reading (the matched single stream's point and range)."""
    out = {"value": line["value"], "vs_baseline": line["vs_baseline"]}
    for k, v in line["secondary"].items():
        if isinstance(v, dict):
            out.update({f"{k}.point": v["point"], f"{k}.min": v["range"][0], f"{k}.max": v["range"][1]})
        elif not isinstance(v, str):
            out[k] = v
    return out


def bench_path() -> dict:
    """Phase 16: `cli bench`, the port's registration benchmark.  The entry
    point once in a subprocess (headline only: its last line holds the root
    ``bench.py``'s keys); K1 at the bench pair's shapes (B = 64, 50
    iterations, no convergence test) against its plain version; then
    `bench.run` with every reading (what ``cli bench --all`` calls) between a
    reset and a reading of the launch counters: every key present and
    finite, every reading on its side of its bound, the bench's own checks
    passed, and K1-K8 each launched.  Returns the launches."""
    from icp_slam_yolo_tpu_torch import bench
    from icp_slam_yolo_tpu_torch.ops import pallas

    t_phase = time.perf_counter()
    out, sub_launches = _cli(["bench"], "cli bench")
    line = json.loads(out.splitlines()[-1])
    _require(all(k in line for k in BENCH_KEYS) and line["metric"] == "icp_registrations_per_sec"
             and line["protocol"] == bench.PROTOCOL, f"cli bench: keys {sorted(line)}")
    _require(all(np.isfinite(v) for v in _bench_numbers(line).values()), f"cli bench: a reading not finite: {line}")
    _require(sub_launches["icp_fused"] > 0, "cli bench: K1 never launched")
    print(f"[16] cli bench (subprocess, headline only; its K1 launches {sub_launches['icp_fused']}): "
          f"{json.dumps(line)}", flush=True)

    src, tgt, data = bench.load_pair()
    cfg = bench.icp_config(early_exit=False)
    one = bench.batched_inputs(src, tgt, 64, "cuda")
    kw = dict(iters=cfg.max_iterations, threshold_mm=cfg.threshold_mm, tolerance=cfg.tolerance)
    _, (dpos, dang, drm, iters), _ = k1_against_plain("bench pair, B = 64", one, kw)
    print(f"[16] K1 at the bench pair's shapes ({data}: 64 x {one[0].shape[1]} source slots ({len(src)} live) x "
          f"{one[2].shape[1]} target slots ({len(tgt)} live), {iters} iterations, no convergence test) against its "
          f"plain version: poses within {dpos:.3g} mm / {dang:.3g} rad, rmse within {drm:.3g} mm (tolerance 1 mm / "
          f"2e-3 rad / 1 mm)", flush=True)
    import torch

    from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import icp_fused

    one1 = tuple(x[:1].contiguous() for x in one)
    kw1 = dict(kw, tolerance=bench.icp_config(early_exit=True).tolerance)
    # CUDA events over back-to-back launches (the profiler degrades after phases 4-6 and 14-15)
    times = [_cuda_ms(torch, lambda: icp_fused(*x, **k), 50) * 1e3 for x, k in ((one, kw), (one1, kw), (one1, kw1))]
    print(f"[16] K1 us a call at the bench pair's shapes (CUDA events over 50 back-to-back launches): B = 64, 50 "
          f"iterations {times[0]:.2f}; B = 1, 50 iterations {times[1]:.2f}; B = 1 to its convergence "
          f"{times[2]:.2f}", flush=True)

    pallas.reset_launches()
    t0 = time.perf_counter()
    res = bench.run(all_readings=True)
    secs = time.perf_counter() - t0
    launches = dict(pallas.LAUNCHES)
    line, detail = res["line"], res["detail"]
    readings = line["secondary"]
    _require(all(k in line for k in BENCH_KEYS), f"bench --all: keys {sorted(line)}")
    _require(all(k in readings for k in BENCH_READINGS), f"bench --all: readings missing: "
             f"{sorted(set(BENCH_READINGS) - set(readings))}")
    _require("implausible_readings" not in readings, f"bench --all: past their bounds: "
             f"{readings.get('implausible_readings')}")
    numbers = _bench_numbers(line)
    _require(all(np.isfinite(v) for v in numbers.values()), f"bench --all: a reading not finite: {numbers}")
    for name, bound in detail["bounds"].items():
        v = line["value"] if name == "icp_registrations_per_sec" else readings[name]
        v = v["point"] if isinstance(v, dict) else v
        _require(v >= bound if name.endswith("_ms") else v <= bound, f"bench --all: {name} {v} past its bound {bound}")
    _require(all(c["ok"] for c in detail["checks"].values()), f"bench --all: checks {detail['checks']}")
    for name in BENCH_KERNELS:
        _require(launches[name] > 0, f"bench --all never launched {name}")
    for name, v in numbers.items():
        bound = detail["bounds"].get(name.split(".")[0] if name.endswith(".point") else name)
        print(f"[16] {name} = {v!r}" + ("" if bound is None else f" (bound {bound!r})"), flush=True)
    print(f"[16] bench --all ({line['data']} scans, {line['device']}): {secs:.1f} s; checks "
          f"{json.dumps(detail['checks'])}; samples {json.dumps(line['samples'])}; launches {launches}", flush=True)
    print(f"[16] phase 16 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", choices=("all", "slam", "knn", "detector", "tick", "serve", "train", "label",
                                             "shared", "dist", "bench"),
                        default="all",
                        help="run every phase (the default: the only run that ends in the result line), or only "
                             "the SLAM and fleet phases 3-6, only phase 3's K9 checks, only the detector phases "
                             "7-9, only the tick (10), "
                             "only the entry points (11: server, CLI, .pt import), only training (12), only "
                             "JPEG decoding and the labeling path (13), only the shared-map fleet (14), only "
                             "the paths across processes (15) or only cli bench (16)")
    phases = parser.parse_args(argv).phases
    t_run = time.perf_counter()

    def lap(what: str) -> None:  # where the script's time goes, phase by phase
        print(f"[t] {what} done at {time.perf_counter() - t_run:.1f} s", flush=True)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from icp_slam_yolo_tpu_torch.ops.pallas import _lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=False,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(f"[1] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _lib.lib()
    build_s = time.perf_counter() - t0
    print(f"[2] built kernels in {build_s:.1f} s", flush=True)
    for source in _lib.SOURCES:  # every kernel's resources, from `ptxas -v`
        for kernel, regs, spill_st, spill_ld, smem in _lib.ptxas_summary(source):
            print(f"[2] {source} {_kernel_name(kernel)}: {regs} registers, {smem} bytes static shared memory, spills "
                  f"{spill_st} bytes stored / {spill_ld} loaded", flush=True)

    import icp_slam_yolo_tpu_torch as port

    # Order: every kernel check and the detector's phases (7-9) run before the
    # SLAM paths (4-6).  After those paths' long profiler windows the tracer
    # was seen to keep 3 records of 10 calls, and then none, in the hundreds
    # of short traces that phase 7 takes; ahead of them it loses none.
    kernels, paths = {}, []
    if phases in ("all", "slam"):
        cfg = slice_config()
        kernels = check_kernels(cfg)
        kernels["raster_update_grid"], batched = check_batched_kernels(port.FLEET_CONFIG)
        check_edge_cases(cfg)
        check_large_window(cfg)
        layouts_checked(("K1", "K2", "K3", "K4"))
    if phases in ("all", "slam", "knn"):
        kernels["knn_outlier"], timed = check_knn_outlier(port.FLEET_CONFIG)
        batched = {**batched, **timed} if phases != "knn" else timed
        print(json.dumps({"batched": batched}))
        lap("phase 3")
    if phases in ("all", "detector"):
        kernels.update(check_detector_kernels())
        for name, err in check_family_sites().items():
            kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
        paths.append(detector_path())
        paths += family_paths()
        paths.append(yolo12_path())
        detector_times()
        for path in FAMILY_CHECKPOINTS:
            detector_times(path)
        lap("phases 7-9")
    if phases in ("all", "tick"):
        paths.append(tick_path())
        lap("phase 10")
    if phases in ("all", "serve"):
        paths.append(serve_path(build_s))
        lap("phase 11")
    if phases in ("all", "train"):
        paths.append(train_path())
        lap("phase 12")
    if phases in ("all", "label"):
        paths.append(label_path())
        lap("phase 13")
    if phases in ("all", "slam"):
        paths += [replay(cfg)[0], fleet(port.FLEET_CONFIG), presets(port.OFFLINE_CONFIG, port.REALTIME_CONFIG)]
        lap("phases 4-6")
    if phases in ("all", "shared"):
        paths.append(shared_path(port.FLEET_CONFIG))
        lap("phase 14")
    if phases in ("all", "dist"):
        paths.append(dist_path(port.FLEET_CONFIG))
        lap("phase 15")
    if phases in ("all", "bench"):
        paths.append(bench_path())
        lap("phase 16")

    rows = []
    order = ("icp_fused", "raster_update", "nn_argmin", "raster_update_grid", *DETECTOR_KERNELS, "knn_outlier")
    _require(phases != "all" or set(kernels) == set(order), f"kernels checked: {sorted(kernels)}")
    for name in (n for n in order if n in kernels):
        row = kernels[name]
        # over the slice, fleet, preset, detector, tick, serve, train, label, shared, dist and bench paths
        row["launches"] = sum(p.get(name, 0) for p in paths)
        _require(row["launches"] > 0 or phases == "knn", f"no path launched {name}")
        rows.append({k: row[k] for k in ("name", "route", "source", "replaces", "launches", "max_abs_err",
                                         "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(json.dumps({"kernels": rows}))
    print(card)
    if phases != "all":
        print(f"chip_smoke: ran the {phases} phases only; the result line is printed by a full run")
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
