"""Benchmark of the port: ICP registrations/s on the card against the float64
NumPy oracle on the CPU (`cli bench`, the counterpart of the root
``bench.py``).

Prints ONE JSON line on stdout, with ``bench.py``'s keys::

  {"metric": "icp_registrations_per_sec", "value": N, "unit": "reg/s",
   "vs_baseline": X, "secondary": {...}, "protocol": "cuda-sync-wall-v1",
   "data": "synthetic" | "Scan_data_1", "device": "<name>, <power limit>",
   "samples": {reading: timed repeats}}

The headline registers one scan pair 64 times a call (``icp_masked`` over a
robot axis: one K1 launch a call), each call's poses feeding the next
call's initial poses, every registration running all 50 iterations.  The
baseline is the port's float64 oracle (`reference_impl.oracle.icp`) on one
CPU thread.  ``--all`` adds the readings of the five ``BASELINE.json``
configurations: the SLAM loop on the default config and the ``offline`` and
``realtime`` presets, the detector at batch 8 and 128, the fleet and its
matched single stream, the fused SLAM + detect tick, and the train step; it
writes them with their bounds to ``chiprun_out/bench_detail_torch.json``.

Timing protocol (``cuda-sync-wall-v1``): a warm-up run, then each reading
is the median over ``repeats`` (at least 5) host-clock intervals, each
ending in ``torch.cuda.synchronize()``: the time a user waits, host
dispatch included.  Each reading has a bound worked out from its work and
the H100's peaks (`BOUNDS`); a reading past it is nulled and listed under
``implausible_readings``, and a headline past it raises.  The command checks
its own outputs and exits non-zero when a check fails: the 64 registrations
within 1 mm and 2e-3 rad of the oracle's pose, finite train losses and
detections, and at least 95 % of synthetic scans accepted by every replay.

Scans: the reference's ``Scan_data_1`` directory when ``scan_dir`` is given
(scans 350 and 355 are the pair), else the seeded synthetic warehouse
(`io/synthetic.py`, `WAREHOUSE`), sized to the configurations' maps.

Run: ``python -m icp_slam_yolo_tpu_torch.cli bench [--all]`` (the card;
``--device cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from icp_slam_yolo_tpu_torch.config import FLEET_CONFIG, OFFLINE_GATE, PRESETS, IcpConfig, MapConfig, SlamConfig
from icp_slam_yolo_tpu_torch.device import resolve_device
from icp_slam_yolo_tpu_torch.io import scans as scans_io
from icp_slam_yolo_tpu_torch.io.synthetic import synthetic_sequence
from icp_slam_yolo_tpu_torch.reference_impl import oracle

PROTOCOL = "cuda-sync-wall-v1"
PAIR = (350, 355)  # the reference's own pairwise-ICP demo pair (`ds.py:80-81`)
SEED = 0  # the synthetic scans, the initial headings, the frames and the weights

# H100 SXM data sheet, dense, at the 700 W limit
PEAK_BYTES = 3.35e12  # HBM bytes/s
PEAK_BF16 = 989e12    # bfloat16 tensor-core operations/s
PEAK_FP32 = 67e12     # float32 operations/s outside the tensor cores

# The synthetic hall every loop replays: 7 m x 10 m, two rack bays a row,
# a 4.8 m x 3 m loop (~93 scans a lap) with 1.05 m to the racks on either
# side.  It fits the fleet's 11.52 m arena (+-5.76 m); its aisles are wider
# than the realtime gate's 1 m floor (in narrower ones the realtime loops
# lose track); and its map fits the 8192 slots the root bench.py gives the
# SLAM loops (the detail file's ``map_points_of_slots``: an offline map
# keeps growing as noisy points fill neighbouring 20 mm voxels).  A 20 m x
# 12 m hall outgrows those slots before its first lap ends, and
# `SlamConfig()` then rejects the scans whose walls were dropped.
WAREHOUSE = dict(half_x=3500.0, half_y=5000.0, path_half_x=2400.0, path_half_y=1500.0, radius=1000.0)
REPEATS = 5  # timed repeats a reading (its median), after a warm-up
MIN_ACCEPT = 0.95  # of synthetic scans, every replay
POSE_TOL = (1.0, 2e-3)  # mm, rad: the card's registrations against the oracle


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, repeats: int, dev: torch.device) -> float:
    """Median seconds of ``repeats`` calls of ``fn`` after one warm-up call,
    each call timed on the host clock up to a synchronisation of ``dev``."""
    if repeats < 5:
        raise ValueError(f"a reading is the median of at least 5 repeats, not {repeats}")
    fn()
    _sync(dev)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def card_description(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (``cpu`` for the CPU)."""
    if dev.type != "cuda":
        return "cpu"
    try:
        lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        lines = []
    index = dev.index or 0
    return lines[index] if index < len(lines) else f"{torch.cuda.get_device_name(dev)}, power limit not read"


# ---------------------------------------------------------------- data


def load_pair(scan_dir: str | None = None):
    """The registration pair: ``(src, tgt, data)``, float64 ``(M, 2)``
    points.  Scans 355 (source, gated and voxel-downsampled at 20 mm, as
    `gicp_lidar.py:20`) and 350 (target, gated) of ``scan_dir``; without
    it, or without those scans, the seeded wall pair of the root
    ``bench.py``, the same numbers."""
    paths = scans_io.sequence_paths(scan_dir, PAIR[0], PAIR[1] + 1) if scan_dir else []
    if len(paths) >= 2:
        a, b = np.load(paths[0]), np.load(paths[-1])
        data = os.path.basename(os.path.normpath(scan_dir))
    else:
        rng = np.random.default_rng(0)
        ang = rng.uniform(0, 135, 300)
        a = np.stack([np.full(300, 40.0), ang, 3000 + 200 * np.sin(np.deg2rad(ang) * 4)], axis=1)
        b = a.copy()
        b[:, 2] += 30.0
        data = "synthetic"
    src = oracle.voxel_downsample(oracle.polar_gate(b, OFFLINE_GATE), 20.0)
    tgt = oracle.polar_gate(a, OFFLINE_GATE)
    return src, tgt, data


def _sequence(n_scans: int, cfg: SlamConfig, scan_dir: str | None, dev) -> torch.Tensor:
    """``(n_scans, n_max, 3)`` scans on ``dev``: the first of ``scan_dir``,
    else the seeded synthetic `WAREHOUSE`."""
    if scan_dir:
        scans, _, _ = scans_io.load_sequence(scan_dir, 1, n_scans + 1, n_max=cfg.n_max)
    else:
        raw, _ = synthetic_sequence(n_scans, SEED, **WAREHOUSE)
        scans = np.zeros((n_scans, cfg.n_max, 3), np.float32)
        scans[:, : raw.shape[1]] = raw
    return torch.from_numpy(scans).to(dev)


def _pad(p: np.ndarray, mult: int):
    n = -(-len(p) // mult) * mult
    out = np.zeros((n, 2), np.float32)
    out[: len(p)] = p
    v = np.zeros(n, bool)
    v[: len(p)] = True
    return out, v


def batched_inputs(src: np.ndarray, tgt: np.ndarray, batch: int, device=None) -> tuple:
    """``batch`` copies of the pair as `icp_masked` takes them: the source
    padded to a multiple of 8 slots, the target to 128, and initial poses at
    the origin with headings drawn in +-0.05 rad (``default_rng(0)``), as
    the root ``bench.py`` lays them out.  Returns ``(src_xy, src_valid,
    tgt_xy, tgt_valid, init_pose)`` on ``device``."""
    dev = resolve_device(device)
    sxy, sv = _pad(src, 8)
    txy, tv = _pad(tgt, 128)
    inits = np.zeros((batch, 3), np.float32)
    inits[:, 2] = np.random.default_rng(0).uniform(-0.05, 0.05, batch)
    tile = lambda x: torch.from_numpy(np.broadcast_to(x, (batch, *x.shape)).copy()).to(dev)  # noqa: E731
    return tile(sxy), tile(sv), tile(txy), tile(tv), torch.from_numpy(inits).to(dev)


def icp_config(early_exit: bool) -> IcpConfig:
    """The registration's settings.  K1 ends each registration at its
    convergence; with early exit off the convergence test is switched off (a
    negative tolerance), so every registration runs all ``max_iterations``:
    the work of the JAX kernel's ``early_exit=False``."""
    return IcpConfig() if early_exit else IcpConfig(early_exit=False, tolerance=-1.0)


# ---------------------------------------------------------------- readings


def bench_baseline(src, tgt, repeats: int = 20) -> float:
    """Oracle registrations/s (float64 NumPy, one pair, one CPU thread): one
    over the median of ``repeats`` registrations."""
    cfg = IcpConfig()
    return 1.0 / _timed(lambda: oracle.icp(src, tgt, np.zeros(3), cfg), repeats, torch.device("cpu"))


def bench_batched(src, tgt, batch: int = 64, n_calls: int = 20, repeats: int = REPEATS, device=None):
    """The headline: registrations/s of ``n_calls`` calls of ``batch``
    registrations (one K1 launch a call), each call's poses feeding the next
    call's initial poses (``p / 2 + pose / 2 + 1e-4``), early exit off.
    Returns ``(reg/s, the first call's poses, their initial poses)``, float64
    ``(batch, 3)``."""
    from icp_slam_yolo_tpu_torch.core.registration import icp_masked

    dev = resolve_device(device)
    s, sv, t, tv, init = batched_inputs(src, tgt, batch, dev)
    cfg = icp_config(early_exit=False)
    first = icp_masked(s, sv, t, tv, init, cfg)

    def chain():
        p = init
        for _ in range(n_calls):
            p = p * 0.5 + icp_masked(s, sv, t, tv, p, cfg).pose * 0.5 + 1e-4

    rate = batch * n_calls / _timed(chain, repeats, dev)
    return rate, first.pose.double().cpu().numpy(), init.double().cpu().numpy()


def bench_single_pair(src, tgt, n_calls: int = 2500, repeats: int = REPEATS, device=None):
    """B = 1 registration latency in ms, chained as `bench_batched`: early
    exit on (each registration ends at its convergence) and off (all 50
    iterations).  Returns ``(converged ms, fixed-50 ms, the converged
    registration's iterations)``."""
    from icp_slam_yolo_tpu_torch.core.registration import icp_masked

    dev = resolve_device(device)
    s, sv, t, tv, init = batched_inputs(src, tgt, 1, dev)
    out = []
    for early_exit in (True, False):
        cfg = icp_config(early_exit)

        def chain():
            p = init
            for _ in range(n_calls):
                p = p * 0.5 + icp_masked(s, sv, t, tv, p, cfg).pose * 0.5 + 1e-4

        out.append(_timed(chain, repeats, dev) / n_calls * 1e3)
    iters = int(icp_masked(s, sv, t, tv, init, icp_config(True)).n_iters[0])
    return out[0], out[1], iters


class Loop(NamedTuple):
    """A SLAM loop's reading and what the checks and bounds need of its
    last run: the share of scans accepted, one robot's state in bytes, and
    the most map points a robot holds against its map's slots."""
    rate: float
    accepted: float
    state_bytes: int
    map_points: int
    map_slots: int


def _nbytes(state) -> int:
    return sum(x.numel() * x.element_size() for x in state)


def _loop(rate: float, state, outs) -> Loop:
    """`Loop` of a run's final state and outputs (one robot, or a fleet
    with a leading robot axis)."""
    valid = state.map_valid.reshape(-1, state.map_valid.shape[-1])
    return Loop(rate, float(outs.accepted.float().mean()), _nbytes(state) // len(valid), int(valid.sum(-1).max()),
                valid.shape[-1])


def bench_sequence(n_scans: int = 300, preset: str | None = None, repeats: int = REPEATS,
                   scan_dir: str | None = None, device=None):
    """The SLAM loop in scans/s: `slam.pipeline.run_sequence` over
    ``n_scans`` scans on the ``preset`` (None: ``SlamConfig()``) with 8192
    map slots (a `Loop`)."""
    from icp_slam_yolo_tpu_torch.slam.pipeline import run_sequence

    dev = resolve_device(device)
    cfg = (PRESETS[preset] if preset else SlamConfig()).replace(map_capacity=8192)
    scans = _sequence(n_scans, cfg, scan_dir, dev)
    last = {}
    secs = _timed(lambda: last.update(run=run_sequence(scans, cfg, dev)), repeats, dev)
    return _loop(n_scans / secs, *last["run"])


def fleet_config() -> SlamConfig:
    """The ``fleet`` preset's semantics at the bench arena's geometry: an
    11.52 m square map (384 x 384 cells), a 100-cell window (rays of 112
    samples) and 4096 map slots, as the root ``bench.py`` sizes it."""
    return FLEET_CONFIG.replace(
        map=MapConfig(width_mm=11520.0, height_mm=11520.0),
        occupancy=dataclasses.replace(FLEET_CONFIG.occupancy, window_px=100, max_ray_px=112),
        map_capacity=4096,
    )


def bench_fleet(n_robots: int = 8, n_scans: int = 100, repeats: int = REPEATS, scan_dir: str | None = None,
                device=None):
    """Fleet throughput in robot-scans/s: `parallel.fleet.fleet_run_sequence`
    on `fleet_config` over ``n_robots`` copies of one stream (a `Loop`)."""
    from icp_slam_yolo_tpu_torch.parallel.fleet import fleet_run_sequence

    dev = resolve_device(device)
    cfg = fleet_config()
    stack = _sequence(n_scans, cfg, scan_dir, dev)[None].repeat(n_robots, 1, 1, 1)
    last = {}
    secs = _timed(lambda: last.update(run=fleet_run_sequence(stack, cfg, dev)), repeats, dev)
    return _loop(n_robots * n_scans / secs, *last["run"])


def bench_fleet_matched_single(n_scans: int = 300, repeats: int = REPEATS, scan_dir: str | None = None,
                               device=None):
    """One stream under `fleet_config` (plus the sequential ``skip_dead_rays``
    flag, which the port's raster does not need): the denominator of the
    fleet's batching efficiency (a `Loop`)."""
    from icp_slam_yolo_tpu_torch.slam.pipeline import run_sequence

    dev = resolve_device(device)
    cfg = fleet_config()
    cfg = cfg.replace(occupancy=dataclasses.replace(cfg.occupancy, skip_dead_rays=True))
    scans = _sequence(n_scans, cfg, scan_dir, dev)
    last = {}
    secs = _timed(lambda: last.update(run=run_sequence(scans, cfg, dev)), repeats, dev)
    return _loop(n_scans / secs, *last["run"])


def forward_flops(model, img_size: int) -> float:
    """Operations of one image's forward (2 a multiply-add), counted from
    the shapes of ``model``'s conv sites (the K5-K8 sites and the plain
    convs) and attention products, on an unfused copy of its architecture
    run on the meta device (no data, no kernel).  Decode and NMS are left
    out."""
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO, Attention2d

    with torch.device("meta"):
        twin = YOLO(num_classes=model.num_classes, variant=model.variant, task=model.task, family=model.family,
                    reg_max=model.reg_max, n_kpt=model.n_kpt, fold_bn=True, fused=False)
    total = [0.0]

    def conv(mod, inputs, out):  # NHWC out
        c = mod.conv
        total[0] += 2.0 * out.shape[1] * out.shape[2] * c.out_channels * (c.in_channels // c.groups) \
            * c.kernel_size[0] * c.kernel_size[1]

    def attention(mod, inputs, out):
        _, h, w, _ = inputs[0].shape
        area = mod.area if (h * w) % mod.area == 0 else 1
        t = h * w // area
        total[0] += 2.0 * area * mod.nh * t * t * (mod.kd + mod.hd)

    hooks = [m.register_forward_hook(attention if isinstance(m, Attention2d) else conv)
             for m in twin.modules()
             if isinstance(m, Attention2d) or isinstance(getattr(m, "conv", None), torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            twin(torch.zeros((1, img_size, img_size, 3), device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def _frames(batch: int, img_size: int, dev) -> torch.Tensor:
    """Seeded uniform frames ``(batch, S, S, 3)`` in [0, 1), made on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    return torch.rand((batch, img_size, img_size, 3), generator=g, device=dev)


def _detections_finite(dets) -> bool:
    v = dets.valid
    return bool(torch.isfinite(dets.boxes[v]).all() and torch.isfinite(dets.scores[v]).all())


def bench_detect(batch: int = 8, img_size: int = 640, n_calls: int = 8, repeats: int = REPEATS, device=None):
    """Detector frames/s: `Detector(num_classes=1)` (yolo-n v8, seeded
    weights, bfloat16, K5-K8) over forward, decode and NMS of ``batch``
    uniform frames, ``n_calls`` calls a repeat.  Returns ``(frames/s,
    operations per image, detections finite)``."""
    from icp_slam_yolo_tpu_torch.models.detect import Detector

    dev = resolve_device(device)
    det = Detector(num_classes=1, img_size=img_size, seed=SEED, device=dev)
    x = _frames(batch, img_size, dev)
    finite = _detections_finite(det.predict_batch(x))

    def calls():
        for _ in range(n_calls):
            det.predict_batch(x)

    return batch * n_calls / _timed(calls, repeats, dev), forward_flops(det.model, img_size), finite


def bench_fused(n_calls: int = 48, detect_every: int = 1, mode: str = "fused", repeats: int = REPEATS,
                scan_dir: str | None = None, img_size: int = 640, device=None):
    """The fused SLAM + detect tick (``BASELINE.json`` configuration 4) in
    ticks/s: one scan step (`make_step`, ``SlamConfig(map_capacity=8192)``)
    and one stereo pair's detect (``predict_batch`` of 2 frames: forward,
    decode, NMS), with the root ``bench.py``'s cross-dependencies: the
    detections' top score moves the next scan's ranges and the pose and
    score move the next frames.  ``detect_every = k`` detects on every k-th
    tick (a host branch); ``mode``: ``fused``, ``slam_only`` or
    ``detect_only``.  Returns ``(ticks/s, the last top score, bytes of the
    SLAM state)``."""
    from icp_slam_yolo_tpu_torch.models.detect import Detector
    from icp_slam_yolo_tpu_torch.slam import pipeline

    if mode not in ("fused", "slam_only", "detect_only"):
        raise ValueError(f"unknown mode {mode}")
    dev = resolve_device(device)
    cfg = SlamConfig(map_capacity=8192)
    scans = _sequence(2, cfg, scan_dir, dev)
    state0 = pipeline.init_state(scans[0], cfg)
    step = pipeline.make_step(cfg)
    det = Detector(num_classes=1, img_size=img_size, seed=SEED, device=dev)
    frames0 = _frames(2, img_size, dev)
    zero = torch.zeros((), device=dev)
    last = {}

    def ticks():
        st, sc, fr, top = state0, scans[1], frames0, zero
        for i in range(n_calls):
            if mode != "detect_only":
                st, _ = step(st, sc)
            if mode == "slam_only" or i % detect_every:
                top = zero
            else:
                top = det.predict_batch(fr).scores.max().float()
            # cross-dependencies: neither half can be left out or reordered
            sc = sc + torch.stack([zero, zero, 1e-4 + top * 1e-6])
            fr = fr + st.pose[0] * 1e-9 + top * 1e-9 + 1e-6
        last.update(top=top, state=st)

    rate = n_calls / _timed(ticks, repeats, dev)
    return rate, float(last["top"]), _nbytes(last["state"])


class _Sgd:
    """optax's ``sgd(lr, momentum)`` as `models.train.make_train_step`
    drives an optimizer: ``params``, ``zero_grad()``, ``step()`` (returns the
    gradients' global norm)."""

    def __init__(self, model: torch.nn.Module, lr: float = 0.01, momentum: float = 0.937):
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.sgd = torch.optim.SGD(self.params, lr=lr, momentum=momentum)

    def zero_grad(self):
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        self.sgd.step()
        return g_norm


def train_batch(batch: int, img_size: int, dev) -> dict:
    """The root ``bench.py``'s train batch: seeded uniform images, 8 copies
    of one box a frame, class 0."""
    box = torch.tensor([100.0, 100.0, 300.0, 260.0], device=dev)
    return {"images": _frames(batch, img_size, dev), "boxes": box.expand(batch, 8, 4).contiguous(),
            "classes": torch.zeros((batch, 8), dtype=torch.int32, device=dev),
            "valid": torch.ones((batch, 8), dtype=torch.bool, device=dev)}


def bench_train(batch: int = 16, img_size: int = 640, n_calls: int = 4, compute_dtype=torch.bfloat16,
                repeats: int = REPEATS, device=None):
    """Train steps/s of yolo-n v8 (one class, flax's initial weights from
    the seed) at the reference's batch 16, 640 px: `make_train_step` with
    SGD (lr 0.01, momentum 0.937), ``compute_dtype`` convs and float32
    master weights.  Returns ``(steps/s, the last step's losses finite)``."""
    from icp_slam_yolo_tpu_torch.models.train import create_train_state, make_train_step
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO

    dev = resolve_device(device)
    model = YOLO(num_classes=1, compute_dtype=compute_dtype)
    state = create_train_state(model, img_size, seed=SEED, tx=_Sgd(model), device=dev)
    step = make_train_step(state.model, state.optimizer, img_size)
    data = train_batch(batch, img_size, dev)
    last = {}

    def steps():
        for _ in range(n_calls):
            _, last["metrics"] = step(state, data)

    rate = n_calls / _timed(steps, repeats, dev)
    return rate, all(math.isfinite(float(v)) for v in last["metrics"].values())


# ---------------------------------------------------------------- bounds


def _rate_bound(ops: float, nbytes: float, peak_ops: float) -> float:
    """Work units a second at the card's roof: one over the larger of the
    work's operations at ``peak_ops`` and its bytes at ``PEAK_BYTES``."""
    return 1.0 / max(ops / peak_ops, nbytes / PEAK_BYTES)


def registration_ops(n_src: int, n_tgt: int, sweeps: int) -> float:
    """Least float32 operations of a registration: every sweep (an
    iteration, or the final residual pass) takes every valid (source,
    target) pair once at 2 operations at least (two multiply-adds of
    ``|p|^2 - 2 p.t + |t|^2``)."""
    return 2.0 * sweeps * n_src * n_tgt


BOUNDS = {
    # name: how its bound follows from its work (the numbers: `bounds`)
    "icp_registrations_per_sec": "registrations/s at the float32 rate: `registration_ops` of the pair's valid "
                                 "points over 51 sweeps (50 iterations and the residual)",
    "single_pair_fixed50_ms": "a floor (a reading below it is implausible): one registration's "
                              "`registration_ops` over 51 sweeps at the float32 rate",
    "single_pair_latency_ms": "a floor: one registration's `registration_ops` over its own iterations + 1 "
                              "sweeps at the float32 rate",
    "sequence_scans_per_sec": "scans/s at the memory rate: a step reads its state and scan and writes its "
                              "state, each once",
    "sequence_scans_per_sec_offline_preset": "as sequence_scans_per_sec, on the offline preset's state",
    "sequence_scans_per_sec_realtime_preset": "as sequence_scans_per_sec, on the realtime preset's state",
    "fleet_scans_per_sec": "robot-scans/s at the memory rate: a robot's step reads its state and scan and "
                           "writes its state, each once",
    "fleet_matched_single_scans_per_sec": "as sequence_scans_per_sec, on the fleet configuration's state",
    "detect_fps_640": "frames/s at the roof: one frame's forward operations (conv and attention shapes) at the "
                      "bfloat16 rate, against its float32 image read once at the memory rate",
    "detect_fps_640_b128": "as detect_fps_640",
    "fused_ticks_per_sec": "ticks/s at the roof: two frames' forward operations at the bfloat16 rate, against "
                           "the scan step's bytes (as sequence_scans_per_sec) and the two frames read once",
    "fused_ticks_per_sec_triggered": "as fused_ticks_per_sec with one detect in 5 ticks",
    "fused_slam_only_ticks_per_sec": "as sequence_scans_per_sec, on the tick's state",
    "fused_detect_b2_only_ticks_per_sec": "as fused_ticks_per_sec without the scan step",
    "train_steps_per_sec_b16_640": "steps/s at the bfloat16 rate: the batch's forward and weight-gradient "
                                   "operations (2 forwards' worth), against the images read once",
    "train_steps_per_sec_f32_b16_640": "as train_steps_per_sec_b16_640; the bfloat16 rate, the card's "
                                       "highest for these convolutions, bounds the float32 step too",
}


def bounds(work: dict) -> dict:
    """Each reading's bound on the H100 from the work this run measured
    (``work``: the pair's valid points, the converged registration's
    iterations, each loop's state bytes, the forward's operations); the
    readings named ``*_ms`` are floors, the others ceilings."""
    out = {}
    ns, nt = work["n_src"], work["n_tgt"]
    fixed = registration_ops(ns, nt, 51)
    out["icp_registrations_per_sec"] = _rate_bound(fixed, 0.0, PEAK_FP32)
    out["single_pair_fixed50_ms"] = fixed / PEAK_FP32 * 1e3
    out["single_pair_latency_ms"] = registration_ops(ns, nt, work["converged_iters"] + 1) / PEAK_FP32 * 1e3
    scan_bytes = SlamConfig().n_max * 3 * 4  # every configuration here pads a scan to 512 rows
    step_bytes = {name: 2 * b + scan_bytes for name, b in work.get("state_bytes", {}).items()}
    for name, b in step_bytes.items():
        out[name] = _rate_bound(0.0, b, PEAK_FP32)
    if "flops_per_image" in work:
        f, img = work["flops_per_image"], work["img_size"] ** 2 * 3 * 4
        out["detect_fps_640"] = out["detect_fps_640_b128"] = _rate_bound(f, img, PEAK_BF16)
        tick = step_bytes["fused_slam_only_ticks_per_sec"]
        out["fused_ticks_per_sec"] = _rate_bound(2 * f, tick + 2 * img, PEAK_BF16)
        out["fused_ticks_per_sec_triggered"] = _rate_bound(2 * f / 5, tick + 2 * img / 5, PEAK_BF16)
        out["fused_detect_b2_only_ticks_per_sec"] = _rate_bound(2 * f, 2 * img, PEAK_BF16)
        train = (2 * work["train_batch"] * f, work["train_batch"] * img)
        out["train_steps_per_sec_b16_640"] = out["train_steps_per_sec_f32_b16_640"] = _rate_bound(*train, PEAK_BF16)
    return out


def guard_implausible(readings: dict, limits: dict) -> dict:
    """Null every reading past its bound (below it for ``*_ms``, above it
    for the rest) and list it with its value and bound under
    ``implausible_readings``; returns the readings."""
    bad = {}
    for name, bound in limits.items():
        v = readings.get(name)
        if isinstance(v, dict):
            v = v.get("point")
        if not isinstance(v, (int, float)):
            continue
        if (v < bound) if name.endswith("_ms") else (v > bound):
            print(f"# IMPLAUSIBLE {name}={v} past its bound {bound} ({BOUNDS[name]}): not reported",
                  file=sys.stderr)
            bad[name] = {"value": v, "bound": bound}
            readings[name] = None
    if bad:
        readings["implausible_readings"] = bad
    return readings


# ---------------------------------------------------------------- the command


class BenchFailed(RuntimeError):
    """A correctness check of the benchmark failed, or the headline passed
    its bound."""


def run(all_readings: bool = False, device=None, scan_dir: str | None = None, sizes: dict | None = None) -> dict:
    """Every reading, checked.  Returns ``{"line": the JSON line's object,
    "detail": the readings with their bounds, checks and sizes}``; raises
    `BenchFailed` when a check fails or the headline passes its bound.

    ``sizes`` overrides the root ``bench.py``'s sizes by name: ``batch``
    (64), ``n_calls`` (20), ``pair_calls`` (2500), ``baseline_repeats``
    (20), ``seq_scans`` (300), ``fleet_robots`` (8), ``fleet_scans``
    (100), ``single_scans`` (300), ``detect_calls`` (8), ``detect_b128``
    (128), ``detect_b128_calls`` (12), ``fused_calls`` (48),
    ``train_batch`` (16), ``train_calls`` (4), ``img_size`` (640)."""
    dev = resolve_device(device)
    z = dict(batch=64, n_calls=20, pair_calls=2500, baseline_repeats=20, seq_scans=300, fleet_robots=8,
             fleet_scans=100, single_scans=300, detect_calls=8, detect_b128=128, detect_b128_calls=12,
             fused_calls=48, train_batch=16, train_calls=4, img_size=640)
    unknown = set(sizes or {}) - set(z)
    if unknown:
        raise ValueError(f"unknown sizes: {sorted(unknown)}")
    z.update(sizes or {})
    kw = dict(device=dev)
    checks = {}

    src, tgt, data = load_pair(scan_dir)
    synthetic = data == "synthetic"
    base = bench_baseline(src, tgt, z["baseline_repeats"])
    ours, got, inits = bench_batched(src, tgt, z["batch"], z["n_calls"], **kw)
    want = np.array([oracle.icp(src, tgt, p, IcpConfig())[0] for p in inits])  # each from the same start
    d_mm = float(np.hypot(*(got[:, :2] - want[:, :2]).T).max())
    d_rad = float(np.abs(got[:, 2] - want[:, 2]).max())
    checks["registrations_match_oracle"] = {"ok": d_mm <= POSE_TOL[0] and d_rad <= POSE_TOL[1],
                                            "mm": d_mm, "rad": d_rad, "tolerance": list(POSE_TOL)}
    pair_ms, pair_fixed_ms, iters = bench_single_pair(src, tgt, z["pair_calls"], **kw)
    print(f"# headline: {ours:.1f} reg/s ({z['batch']} registrations a call, {z['n_calls']} chained calls, "
          f"50 iterations each; {data} pair, {len(src)} x {len(tgt)} points); poses within {d_mm:.4g} mm / "
          f"{d_rad:.4g} rad of the oracle's", file=sys.stderr)
    print(f"# baseline (NumPy oracle, CPU): {base:.1f} reg/s", file=sys.stderr)
    print(f"# single-pair (B=1) latency: {pair_ms:.4f} ms converged ({iters} iterations) / {pair_fixed_ms:.4f} ms "
          f"fixed-50", file=sys.stderr)

    secondary = {"single_pair_latency_ms": pair_ms, "single_pair_fixed50_ms": pair_fixed_ms}
    work = {"n_src": len(src), "n_tgt": len(tgt), "converged_iters": iters, "state_bytes": {}}
    run_sizes = {"pair": [len(src), len(tgt)], **z}
    if all_readings:
        loops = {}
        for preset, name in ((None, "sequence_scans_per_sec"), ("offline", "sequence_scans_per_sec_offline_preset"),
                             ("realtime", "sequence_scans_per_sec_realtime_preset")):
            loops[name] = bench_sequence(z["seq_scans"], preset, scan_dir=scan_dir, **kw)
            secondary[name] = loops[name].rate
            print(f"# full-sequence SLAM loop ({preset or 'SlamConfig()'}, 8192 map slots): {loops[name].rate:.1f} "
                  f"scans/s, accepted {loops[name].accepted:.4f}", file=sys.stderr)
        fps, flops, finite8 = bench_detect(8, z["img_size"], z["detect_calls"], **kw)
        fps128, _, finite128 = bench_detect(z["detect_b128"], z["img_size"], z["detect_b128_calls"], **kw)
        checks["detections_finite"] = {"ok": finite8 and finite128}
        work.update(flops_per_image=flops, img_size=z["img_size"], train_batch=z["train_batch"])
        achieved, achieved128 = fps * flops / 1e12, fps128 * flops / 1e12
        secondary.update(
            detect_fps_640=fps, detect_gflop_per_image=flops / 1e9,
            detect_flops_note="gflop counted from the model's conv and attention shapes (forward only); MFU "
                              "against the H100's dense bfloat16 peak (989 TFLOP/s)",
            detect_achieved_tflops=achieved, detect_mfu=achieved * 1e12 / PEAK_BF16,
            detect_fps_640_b128=fps128, detect_mfu_b128=achieved128 * 1e12 / PEAK_BF16)
        print(f"# YOLO detect: {fps:.1f} FPS @{z['img_size']}px bf16 batch 8 ({flops / 1e9:.2f} GFLOP/img, "
              f"{achieved:.2f} TFLOP/s, {secondary['detect_mfu'] * 100:.2f}% MFU); batch {z['detect_b128']}: "
              f"{fps128:.1f} FPS ({secondary['detect_mfu_b128'] * 100:.2f}% MFU)", file=sys.stderr)

        loops["fleet_scans_per_sec"] = bench_fleet(z["fleet_robots"], z["fleet_scans"], scan_dir=scan_dir, **kw)
        fleet = loops["fleet_scans_per_sec"].rate
        singles = []
        for _ in range(3):
            loops["fleet_matched_single_scans_per_sec"] = bench_fleet_matched_single(z["single_scans"],
                                                                                     scan_dir=scan_dir, **kw)
            singles.append(loops["fleet_matched_single_scans_per_sec"].rate)
        single = float(np.median(singles))
        secondary["fleet_scans_per_sec"] = fleet
        secondary["fleet_matched_single_scans_per_sec"] = {"point": single, "range": [min(singles), max(singles)]}
        print(f"# fleet SLAM ({z['fleet_robots']} robots, `fleet` preset flags): {fleet:.1f} robot-scans/s "
              f"(matched single stream: {single:.1f} [{min(singles):.1f}-{max(singles):.1f}]; batching "
              f"efficiency {fleet / single:.2f}x)", file=sys.stderr)

        fused, top, tick_bytes = bench_fused(z["fused_calls"], scan_dir=scan_dir, img_size=z["img_size"], **kw)
        slam_only = bench_fused(z["fused_calls"], mode="slam_only", scan_dir=scan_dir, img_size=z["img_size"], **kw)[0]
        det_only, top2, _ = bench_fused(z["fused_calls"], mode="detect_only", scan_dir=scan_dir,
                                        img_size=z["img_size"], **kw)
        trig = bench_fused(z["fused_calls"], detect_every=5, scan_dir=scan_dir, img_size=z["img_size"], **kw)[0]
        checks["detections_finite"]["ok"] &= math.isfinite(top) and math.isfinite(top2)
        secondary.update(fused_ticks_per_sec=fused, fused_ticks_per_sec_triggered=trig,
                         fused_slam_only_ticks_per_sec=slam_only, fused_detect_b2_only_ticks_per_sec=det_only)
        print(f"# fused SLAM+detect tick: {fused:.1f} ticks/s (slam-only {slam_only:.1f}, detect-b2-only "
              f"{det_only:.1f}; every 5th {trig:.1f})", file=sys.stderr)

        amp, amp_ok = bench_train(z["train_batch"], z["img_size"], z["train_calls"], torch.bfloat16, **kw)
        f32, f32_ok = bench_train(z["train_batch"], z["img_size"], z["train_calls"], torch.float32, **kw)
        checks["train_losses_finite"] = {"ok": amp_ok and f32_ok}
        secondary.update(train_steps_per_sec_b16_640=amp, train_steps_per_sec_f32_b16_640=f32)
        print(f"# detect train step (batch {z['train_batch']}, {z['img_size']}px): {amp:.2f} steps/s bf16 / "
              f"{f32:.2f} f32", file=sys.stderr)
        secondary["baseline_cpu_reg_per_sec"] = base
        work["state_bytes"] = {k: v.state_bytes for k, v in loops.items()}
        work["state_bytes"]["fused_slam_only_ticks_per_sec"] = tick_bytes
        if synthetic:
            accept = {k: v.accepted for k, v in loops.items()}
            checks["sequences_accept"] = {"ok": min(accept.values()) >= MIN_ACCEPT, "least": MIN_ACCEPT, **accept}
        run_sizes.update(warehouse=WAREHOUSE if synthetic else None,
                         map_points_of_slots={k: [v.map_points, v.map_slots] for k, v in loops.items()})

    limits = bounds(work)
    # timed repeats behind each reading: every timed reading has a bound; the matched single stream is 3 readings
    samples = {"value": REPEATS, "baseline": z["baseline_repeats"], **{k: REPEATS for k in limits if k in secondary}}
    if "fleet_matched_single_scans_per_sec" in samples:
        samples["fleet_matched_single_scans_per_sec"] = 3 * REPEATS
    if ours > limits["icp_registrations_per_sec"]:
        raise BenchFailed(f"headline implausible: {ours} reg/s past its bound {limits['icp_registrations_per_sec']} "
                          f"({BOUNDS['icp_registrations_per_sec']})")
    secondary = guard_implausible(secondary, limits)
    failed = sorted(k for k, c in checks.items() if not c["ok"])
    line = {"metric": "icp_registrations_per_sec", "value": ours, "unit": "reg/s", "vs_baseline": ours / base,
            "secondary": secondary, "protocol": PROTOCOL, "data": data, "device": card_description(dev),
            "samples": samples}
    detail = {"icp_registrations_per_sec": ours, **secondary, "bounds": limits,
              "bound_derivations": {k: BOUNDS[k] for k in limits}, "checks": checks, "sizes": run_sizes,
              "protocol": PROTOCOL, "data": data, "device": line["device"], "samples": samples}
    if failed:
        raise BenchFailed(f"checks failed: {failed}: {json.dumps({k: checks[k] for k in failed})}")
    return {"line": line, "detail": detail}


DETAIL_PATH = os.path.join("chiprun_out", "bench_detail_torch.json")


def main(all_readings: bool = False, device=None, scan_dir: str | None = None) -> dict:
    """`cli bench`: `run`, then the detail file (``--all``, under the
    checkout's ``chiprun_out/``) and the JSON line on stdout."""
    try:
        out = run(all_readings, device, scan_dir)
    except BenchFailed as e:
        raise SystemExit(f"bench: {e}") from None
    if all_readings:
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), DETAIL_PATH)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out["detail"], f, indent=2)
        print(f"# wrote {path}", file=sys.stderr)
    print(json.dumps(out["line"]), flush=True)
    return out
