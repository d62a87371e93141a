"""Shared server state: the SLAM engine, POIs, target, stream flags; the
counterpart of the JAX package's ``serve/state.py``.

One lock-guarded object owns the engine, the points of interest (persisted
to ``points_of_interest.json`` in the reference's format: a JSON list of
``[x_mm, y_mm]``), the active target and the pause/capture flags.  A
background thread replays a scan source through the engine (the reference's
SLAM daemon thread), and `attach_camera` wires the trigger-gated stereo
detector into the landmark map.

``device=None`` runs the engine on the card (and raises without one);
``device="cpu"`` runs the kernels' plain versions.  The detector is the
caller's: `cli serve` builds it with ``detector_from_checkpoint``'s default,
the unfused convolutions, as the JAX server does.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time

import numpy as np
import torch

from icp_slam_yolo_tpu_torch.config import CAMERA_TRIGGER_DISTANCE_MM, ROBOT_AXIS_LENGTH_MM, SlamConfig
from icp_slam_yolo_tpu_torch.convert import state_from_numpy
from icp_slam_yolo_tpu_torch.io import maps as maps_io
from icp_slam_yolo_tpu_torch.io import scans as scans_io
from icp_slam_yolo_tpu_torch.slam.api import Slam
from icp_slam_yolo_tpu_torch.utils.images import encode_jpeg, encode_png

POI_FILE = "points_of_interest.json"


def _triangle_weights(n_out: int, n_in: int) -> np.ndarray:
    """``(n_out, n_in)`` weights of a triangle filter as wide as the
    downscale factor, centred on each output pixel (bilinear resampling
    with its support stretched to the scale)."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    centre = (np.arange(n_out) + 0.5) * scale
    w = np.clip(1.0 - np.abs((np.arange(n_in)[None] + 0.5 - centre[:, None]) / support), 0.0, None)
    return w / w.sum(axis=1, keepdims=True)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Downscale a uint8 gray image by separable triangle filtering (in
    float64: within one gray level of the fixed-point bilinear resampling
    of imaging libraries)."""
    h, w = img.shape
    out = _triangle_weights(height, h) @ img.astype(np.float64) @ _triangle_weights(width, w).T
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


class ServerState:
    def __init__(self, cfg: SlamConfig = SlamConfig(), work_dir: str = ".", poi_file: str | None = None,
                 device=None):
        self.cfg = cfg
        self.work_dir = work_dir
        self.lock = threading.RLock()
        self.engine = Slam(cfg, device=device)
        self.points_of_interest: list[list[float]] = []
        self.active_target: dict | None = None
        self.paused = threading.Event()
        self.stopped = threading.Event()
        self.capture_requested = False
        self.show_map = True
        self.show_icp = True
        self.update_mode = 1  # 1 = mapping, 0 = localization
        self.distance_to_target: float | None = None
        self.camera_trigger = False
        self.last_scan_points_px: list[tuple[int, int]] = []
        self.last_scan_sensor = np.zeros((0, 2))
        self.last_camera_data: dict | None = None
        # latest annotated stereo JPEGs [left, right] + a sequence counter so
        # /camera_feed only pushes new frames
        self.last_annotated_jpeg: list[bytes | None] = [None, None]
        self.camera_frame_seq = 0
        self.landmarks = None  # a LandmarkMap once a camera is attached
        self._camera_worker = None
        self._thread: threading.Thread | None = None
        self.poi_path = poi_file or os.path.join(work_dir, POI_FILE)
        self.load_pois()

    # --- POIs ----------------------------------------------------------------
    def load_pois(self) -> None:
        if os.path.exists(self.poi_path):
            with open(self.poi_path) as f:
                self.points_of_interest = json.load(f)

    def save_pois(self) -> None:
        with self.lock:
            with open(self.poi_path, "w") as f:
                json.dump(self.points_of_interest, f, indent=2)

    def add_poi(self) -> list[float]:
        with self.lock:
            pos = [float(self.engine.pose[0]), float(self.engine.pose[1])]
            self.points_of_interest.append(pos)
            self.save_pois()
            return pos

    def set_target(self, point_id: int | None):
        with self.lock:
            if point_id is None:
                self.active_target = None
                return True
            if 0 <= point_id < len(self.points_of_interest):
                self.active_target = {"id": point_id, "pos_mm": self.points_of_interest[point_id]}
                return True
            self.active_target = None
            return False

    # --- pixel conversions ---------------------------------------------------
    def world_to_px(self, x: float, y: float) -> tuple[int, int]:
        cx, cy = self.cfg.map.center_px
        res = self.cfg.map.resolution_mm_per_px
        return int(cx + x / res), int(cy - y / res)

    def pose_payload(self) -> dict:
        x, y, theta = self.engine.pose
        px, py = self.world_to_px(x, y)
        ex = int(px + ROBOT_AXIS_LENGTH_MM * math.cos(theta) / self.cfg.map.resolution_mm_per_px)
        ey = int(py - ROBOT_AXIS_LENGTH_MM * math.sin(theta) / self.cfg.map.resolution_mm_per_px)
        return {"x": px, "y": py, "ex": ex, "ey": ey}

    def stream_payload(self) -> dict:
        with self.lock:
            payload: dict = {}
            if self.last_scan_points_px:
                payload["points"] = self.last_scan_points_px
            payload["pose"] = self.pose_payload()
            if self.distance_to_target is not None:
                payload["distance"] = f"{self.distance_to_target:.2f}"
            if self.engine.rmse_history:
                payload["rmse"] = f"{self.engine.rmse_history[-1]:.2f}"
            if self.last_camera_data is not None:
                payload["camera_data"] = self.last_camera_data
            return payload

    # --- SLAM worker -----------------------------------------------------------
    def feed_scan(self, scan: np.ndarray) -> dict:
        """One scan through the engine + bookkeeping (target distance, trigger).

        The engine step runs under the state lock: `load_map` and
        `resume_mapping` swap the engine's state and step under the same lock,
        and an unlocked step in flight would write a stale mapping-mode state
        back over a freshly loaded map."""
        with self.lock:
            out = self.engine.add_scan(scan)
            pose = out["pose"]
            pts = scans_io.polar_gate(np.asarray(scan), self.cfg.gate)
            self.last_scan_sensor = pts
            world = scans_io.se2_apply(np.asarray(pose, float), pts)
            self.last_scan_points_px = [self.world_to_px(p[0], p[1]) for p in world]
            self._update_target_distance(pose)
        return out

    def _update_target_distance(self, pose=None) -> None:
        """Refresh distance-to-target + the camera trigger (within 1 m of the
        target).  Called from `feed_scan` per scan and from the camera's
        trigger-sync loop, so a target set after the scan stream ends still
        fires the camera."""
        with self.lock:
            if pose is None:
                pose = self.engine.pose
            if self.active_target is not None:
                tx, ty = self.active_target["pos_mm"]
                self.distance_to_target = math.hypot(tx - pose[0], ty - pose[1])
                self.camera_trigger = self.distance_to_target < CAMERA_TRIGGER_DISTANCE_MM
            else:
                self.distance_to_target = None
                self.camera_trigger = False

    def warmup(self, detector=None) -> dict:
        """Pay the first-use costs before serving, so the first real scan and
        the first trigger do not: on the card, build the CUDA kernels (the
        build is cached on disk, so a later start loads it); then feed two
        synthetic scans (the first only starts the map; the second runs a
        whole step, which launches the ICP, nearest-neighbour and raster
        kernels) and reset; with a detector, run one frame and one stereo
        pair (the batch-2 forward the camera worker runs) on 480 x 640
        zeros.  Returns the seconds spent: ``{"build_s", "slam_s",
        "detector_s", "total_s"}``."""
        t0 = time.perf_counter()
        if self.engine.device.type == "cuda":
            from icp_slam_yolo_tpu_torch.ops.pallas import _lib

            _lib.lib()
        t1 = time.perf_counter()
        synth = np.zeros((64, 3))
        synth[:, 0] = 30.0
        synth[:, 1] = np.linspace(0, 100, 64)
        synth[:, 2] = 2000.0
        self.feed_scan(synth)
        self.feed_scan(synth)
        with self.lock:
            self.engine.reset()
            self.last_scan_points_px = []
            self.last_scan_sensor = np.zeros((0, 2))
        t2 = time.perf_counter()
        if detector is not None:
            frame = np.zeros((480, 640, 3), np.uint8)
            detector(frame)
            if hasattr(detector, "detect_pair"):
                detector.detect_pair(frame, frame)
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)
        t3 = time.perf_counter()
        return {"build_s": t1 - t0, "slam_s": t2 - t1, "detector_s": t3 - t2, "total_s": t3 - t0}

    def start_replay(self, scan_dir: str, start: int = 1, end: int | None = None, rate_hz: float = 10.0):
        """Background replay thread (the reference's SLAM daemon); a scan that
        fails to load or step is skipped, as the reference does."""
        def worker():
            paths = (scans_io.sequence_paths(scan_dir, start, end) if end is not None
                     else scans_io.discover_sequence(scan_dir)[start - 1:])
            for p in paths:
                if self.stopped.is_set():
                    break
                while self.paused.is_set() and not self.stopped.is_set():
                    time.sleep(0.05)
                try:
                    self.feed_scan(scans_io.load_scan(p))
                except Exception:
                    continue
                time.sleep(max(0.0, 1.0 / rate_hz))

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    # --- map persistence and rendering -------------------------------------
    def save_map(self, base_name: str) -> None:
        path = os.path.join(self.work_dir, base_name)
        self.engine.save_map(path, self.cfg.map)

    def map_png_bytes(self) -> bytes:
        return encode_png(maps_io.occupancy_to_image(self.engine.occupancy()))

    TILE_PX = 256

    def map_tiles_meta(self) -> dict:
        """Deep-zoom pyramid metadata for `/map_viewer`.  Level ``zmax`` is
        native resolution; each lower level halves it."""
        h, w = self.cfg.map.height_px, self.cfg.map.width_px
        zmax = max(0, math.ceil(math.log2(max(h, w) / self.TILE_PX)))
        cx, cy = self.cfg.map.center_px
        return {
            "width": w, "height": h, "tile": self.TILE_PX, "zmax": zmax,
            "mm_per_px": self.cfg.map.resolution_mm_per_px,
            "center_px": [cx, cy],
        }

    def _tile_level(self, z: int, ttl_s: float = 0.5) -> np.ndarray:
        """Level-``z`` uint8 rendering of the live map, cached for ``ttl_s``:
        a viewer redraw fetches dozens of tiles of one level, and each would
        otherwise copy the whole grid off the device and resize it.  Tile
        requests arrive on concurrent handler threads, so under the lock."""
        with self.lock:
            now = time.time()
            if now - getattr(self, "_tile_cache_t", 0.0) > ttl_s:
                self._tile_cache = {}
                self._tile_cache_t = now
            lvl = self._tile_cache.get(z)
            if lvl is None:
                img = self._tile_cache.get("native")
                if img is None:
                    img = maps_io.occupancy_to_image(self.engine.occupancy())
                    self._tile_cache["native"] = img
                h, w = img.shape
                scale = 2**z
                lvl = resize_bilinear(img, max(1, round(w / scale)), max(1, round(h / scale))) if scale > 1 else img
                self._tile_cache[z] = lvl
            return lvl

    def map_tile_png(self, z: int, x: int, y: int) -> bytes:
        """One ``TILE_PX``-square PNG tile of the live occupancy map at pyramid
        level ``z`` (0 = coarsest).  Out-of-map area is unpainted gray (127),
        `occupancy_to_image`'s unknown value."""
        h, w = self.cfg.map.height_px, self.cfg.map.width_px
        t = self.TILE_PX
        zmax = max(0, math.ceil(math.log2(max(h, w) / t)))
        z = max(0, min(int(z), zmax))
        lvl = self._tile_level(zmax - z)
        lh, lw = lvl.shape
        canvas = np.full((t, t), 127, np.uint8)
        x0, y0 = int(x) * t, int(y) * t
        if 0 <= x0 < lw and 0 <= y0 < lh:
            part = lvl[y0:y0 + t, x0:x0 + t]
            canvas[:part.shape[0], :part.shape[1]] = part
        return encode_png(canvas)

    # --- the fused perception loop -----------------------------------------
    def attach_camera(self, detector, stereo, poll_s: float = 0.1) -> None:
        """Wire the perception loop: when the robot is within trigger distance
        of the target, run the detector on stereo pairs (one batch-2
        ``detect_pair`` when the frames match), compute the pallet alignment
        from keypoint corners (when all four of both eyes are confident) or
        the first box's corners, publish it on the stream as ``camera_data``
        and fuse the detection into the landmark map at the current pose."""
        from icp_slam_yolo_tpu_torch.acquisition.camera import TriggeredCameraWorker
        from icp_slam_yolo_tpu_torch.fusion import LandmarkMap, fuse_stereo_pair

        if self.landmarks is None:
            self.landmarks = LandmarkMap()
        trigger = threading.Event()
        self._camera_trigger_event = trigger

        def on_pair(f1, f2):
            if hasattr(detector, "detect_pair") and f1.shape == f2.shape:
                out1, out2 = detector.detect_pair(f1, f2)
            else:
                out1, out2 = detector(f1), detector(f2)
            camera_data = None
            with self.lock:
                fused = fuse_stereo_pair(out1, out2, self.engine.pose, self.landmarks)
                if fused is not None:
                    align = fused[0]
                    camera_data = {
                        "yaw_deg": round(float(np.rad2deg(align.yaw_rad.cpu().numpy())), 2),
                        "distance_mm": round(float(align.distance_mm), 1),
                        "lateral_mm": round(float(align.lateral_offset_mm), 1),
                        "direction": int(align.direction),
                    }
                    self.last_camera_data = camera_data
            # an eye without a pallet still publishes its (box-annotated) frames
            self._publish_annotated((f1, out1), (f2, out2), camera_data)

        worker = TriggeredCameraWorker(stereo, trigger, self.stopped, on_pair, poll_s)
        worker.start()
        self._camera_worker = worker

        def trigger_sync():  # mirror the SLAM-side flag into the worker's event
            while not self.stopped.is_set():
                # with a target, re-evaluate the distance, so a target set while
                # no scans flow still fires the camera; without one, leave the
                # flag to feed_scan or manual control
                if self.active_target is not None:
                    self._update_target_distance()
                if self.camera_trigger:
                    trigger.set()
                else:
                    trigger.clear()
                time.sleep(poll_s)

        threading.Thread(target=trigger_sync, daemon=True).start()

    def _publish_annotated(self, eye0, eye1, camera_data: dict | None) -> None:
        """Render the operator overlay onto both stereo frames and keep them
        as JPEGs for `/camera_feed` and `/camera_image`."""
        from icp_slam_yolo_tpu_torch.io.render import annotate_detections

        jpegs = [encode_jpeg(annotate_detections(frame, dets, camera_data), quality=85) for frame, dets in (eye0, eye1)]
        with self.lock:
            self.last_annotated_jpeg = jpegs
            self.camera_frame_seq += 1

    def camera_frame_jpeg(self, eye: int) -> bytes | None:
        """Latest annotated frame for one eye (0 = left, 1 = right), or None
        before the camera worker has produced one."""
        with self.lock:
            if eye not in (0, 1):
                return None
            return self.last_annotated_jpeg[eye]

    def landmark_markers(self) -> list[dict]:
        with self.lock:
            return [] if self.landmarks is None else self.landmarks.to_pixel_markers(self.cfg.map)

    def icp_view_png_bytes(self) -> bytes:
        """ICP debug view: the map vs the current scan in the robot frame."""
        from icp_slam_yolo_tpu_torch.io.render import icp_debug_view

        with self.lock:
            img = icp_debug_view(self.engine.map_points(), self.last_scan_sensor, self.engine.pose)
        return encode_png(img)

    # --- saved maps and localization ----------------------------------------
    def _blank_state(self):
        """A `SlamState` with an empty map at the identity pose on the engine's
        device, for loading a saved map before any scan has been fed."""
        cfg = self.cfg
        return state_from_numpy({
            "pose": np.zeros(3, np.float32), "prev_pose": np.zeros(3, np.float32),
            "map_xy": np.zeros((cfg.map_capacity, 2), np.float32), "map_valid": np.zeros(cfg.map_capacity, bool),
            "occ": np.full((cfg.map.height_px, cfg.map.width_px), 0.5, np.float32),
            "prev_xy": np.zeros((cfg.n_max, 2), np.float32), "prev_valid": np.zeros(cfg.n_max, bool),
            "step": np.int32(0), "maint_count": np.int32(0), "reject_run": np.int32(0),
        }, self.engine.device)

    def _fill_map_points(self, pts_xy: np.ndarray) -> None:
        cap = self.cfg.map_capacity
        xy = np.zeros((cap, 2), np.float32)
        n = min(len(pts_xy), cap)
        xy[:n] = pts_xy[:n, :2]
        valid = np.zeros(cap, bool)
        valid[:n] = True
        dev = self.engine.device
        self.engine.state = self.engine.state._replace(map_xy=torch.from_numpy(xy).to(dev),
                                                       map_valid=torch.from_numpy(valid).to(dev))

    def load_map(self, filepath: str) -> None:
        """Load a PNG/JPEG occupancy or PCD point map and switch the engine
        to localization (the map is frozen and ICP tracks the pose against
        it).  An image's point map is the sibling ``.npy`` that `save_map`
        writes, or else the occupied cells' corners.  Other formats raise
        ``ValueError``."""
        with self.lock:
            lower = filepath.lower()
            if not lower.endswith((".png", ".jpg", ".jpeg", ".pcd")):
                raise ValueError("unsupported map format")
            if self.engine.state is None:
                self.engine.state = self._blank_state()
            if not lower.endswith(".pcd"):
                occ = maps_io.load_occupancy_png(filepath)
                if occ.shape != (self.cfg.map.height_px, self.cfg.map.width_px):
                    raise ValueError("map image size does not match the configured grid")
                self.engine.state = self.engine.state._replace(occ=torch.from_numpy(occ).to(self.engine.device))
                npy = os.path.splitext(filepath)[0] + ".npy"
                if os.path.exists(npy):
                    pts = maps_io.load_map_points_npy(npy, self.cfg.map)
                else:
                    py, px = np.nonzero(occ > self.cfg.occupancy.block_threshold)
                    pts = maps_io.pixels_to_points(np.stack([px, py], axis=1), self.cfg.map)
                self._fill_map_points(pts.astype(np.float32))
            else:
                self._fill_map_points(maps_io.load_pcd(filepath))
            self.engine.set_localization(True)
            self.update_mode = 0

    def resume_mapping(self) -> None:
        """Leave localization: the engine's step inserts scans into the
        (loaded or built) map again."""
        with self.lock:
            self.engine.set_localization(False)
            self.update_mode = 1
