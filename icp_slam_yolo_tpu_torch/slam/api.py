"""High-level host API (counterpart of the JAX package's ``slam/api.py``):
construct, feed scans, read poses and maps, save and resume the state."""

from __future__ import annotations

import numpy as np
import torch

from icp_slam_yolo_tpu_torch.config import MapConfig, SlamConfig
from icp_slam_yolo_tpu_torch.convert import state_from_numpy, state_to_numpy
from icp_slam_yolo_tpu_torch.device import resolve_device
from icp_slam_yolo_tpu_torch.io import maps as maps_io
from icp_slam_yolo_tpu_torch.io import scans as scans_io
from icp_slam_yolo_tpu_torch.ops.geometry import se2_to_mat44
from icp_slam_yolo_tpu_torch.slam import pipeline


class Slam:
    """Streaming SLAM engine: ``add_scan`` per scan or ``run`` for a sequence.

    ``device=None`` means the card; without one this raises unless
    ``device="cpu"`` is passed.
    """

    def __init__(self, cfg: SlamConfig = SlamConfig(), device=None):
        self.device = resolve_device(device)
        pipeline.check_supported_config(cfg, self.device)
        self.cfg = cfg
        self._step = pipeline.make_step(cfg)
        self.state: pipeline.SlamState | None = None
        self.trajectory: list[np.ndarray] = []
        self.rmse_history: list[float] = []

    def reset(self) -> None:
        self.state = None
        self.trajectory = []
        self.rmse_history = []

    def set_localization(self, enabled: bool) -> None:
        """Switch between mapping and localization-only (frozen map) steps,
        keeping the current state."""
        if self.cfg.localization_only != bool(enabled):
            self.cfg = self.cfg.replace(localization_only=bool(enabled))
            self._step = pipeline.make_step(self.cfg)

    def add_scan(self, scan: np.ndarray) -> dict:
        """Feed one raw polar scan ``(N, 3)``; returns the step's outputs as
        host values (this reads the card once per scan)."""
        padded = scans_io.pad_scan(np.asarray(scan, np.float64), self.cfg.n_max)
        scan_t = torch.from_numpy(padded).to(self.device)
        if self.state is None:
            self.state = pipeline.init_state(scan_t, self.cfg)
            out = {"pose": np.zeros(3), "rmse": 0.0, "accepted": True, "n_iters": 0}
        else:
            self.state, o = self._step(self.state, scan_t)
            out = {
                "pose": o.pose.cpu().numpy(),
                "rmse": float(o.rmse),
                "accepted": bool(o.accepted),
                "n_iters": int(o.n_iters),
            }
        self.trajectory.append(out["pose"])
        self.rmse_history.append(out["rmse"])
        return out

    def run(self, scans: np.ndarray):
        """Replay a padded stack ``(T, n_max, 3)``; returns ``(state, outputs)``."""
        state, outs = pipeline.run_sequence(scans, self.cfg, device=self.device)
        self.state = state
        poses = np.concatenate([np.zeros((1, 3)), outs.pose.cpu().numpy()], axis=0)
        self.trajectory = list(poses)
        self.rmse_history = [0.0] + list(outs.rmse.cpu().numpy())
        return state, outs

    # --- accessors -------------------------------------------------------
    @property
    def pose(self) -> np.ndarray:
        return np.zeros(3) if self.state is None else self.state.pose.cpu().numpy()

    @property
    def pose44(self) -> np.ndarray:
        """The pose as a 4 x 4 homogeneous transform (float32)."""
        return se2_to_mat44(torch.as_tensor(self.pose, dtype=torch.float32)).numpy()

    def map_points(self) -> np.ndarray:
        if self.state is None:
            return np.zeros((0, 2), np.float32)
        return self.state.map_xy.cpu().numpy()[self.state.map_valid.cpu().numpy()]

    def occupancy(self) -> np.ndarray:
        if self.state is None:
            mc = self.cfg.map
            return np.full((mc.height_px, mc.width_px), 0.5, np.float32)
        return self.state.occ.cpu().numpy()

    # --- the reference's artifacts: occupancy PNG + pixel-coords npy, PCD ---
    def save_map(self, base_path: str, map_cfg: MapConfig | None = None) -> None:
        """``<base_path>.png`` (the occupancy rendering) and ``<base_path>.npy``
        (the map points in pixel coordinates of ``map_cfg``, by default the
        engine's map)."""
        mc = map_cfg or self.cfg.map
        maps_io.save_occupancy_png(self.occupancy(), base_path + ".png")
        maps_io.save_map_points_npy(self.map_points(), base_path + ".npy", mc)

    def save_pcd(self, path: str) -> None:
        maps_io.save_pcd(self.map_points(), path)

    # --- persistence: the same .npz layout as the JAX package's Slam -------
    def save_state(self, path: str) -> None:
        if self.state is None:
            raise RuntimeError("no state to save")
        np.savez_compressed(path, **state_to_numpy(self.state))

    def load_state(self, path: str) -> None:
        with np.load(path if path.endswith(".npz") else path + ".npz") as data:
            self.state = state_from_numpy(data, self.device)
