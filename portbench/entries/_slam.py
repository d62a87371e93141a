"""What the SLAM entries share: the configuration as the program takes it
and as the reference reads it, the scan feed, the set-up lap, and the K1
work of the traced steps."""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import Session, sampled_calls
from portbench.reference import slam as ref
from portbench.scans import Feed, fleet_streams

FEED_STEPS = 32768  # steps the feed's index table covers; a run makes far fewer
_WORK = ref.Precision(torch.float32, False)


def program_config(d: dict):
    """The configuration file's ``slam`` block as the program's `SlamConfig`."""
    from icp_slam_yolo_tpu_torch import config as pc

    nested = {"gate": pc.GateConfig, "map": pc.MapConfig, "icp": pc.IcpConfig, "occupancy": pc.OccupancyConfig}
    kw = {k: (nested[k](**v) if k in nested else v) for k, v in d.items()}
    return pc.SlamConfig(**kw)


def reference_config(config: dict) -> dict:
    return dict(config["slam"], maintenance_interval=config["maintenance_interval"])


def read_answers(pose: torch.Tensor, accepted: torch.Tensor) -> torch.Tensor:
    """Every robot's pose and accept flag on the host: one copy."""
    return torch.cat([pose, accepted[:, None].to(pose.dtype)], 1).cpu()


class SlamSession(Session):
    """The parts of a SLAM session both entries use; subclasses set
    ``init_program``, ``step_program`` and ``judge``."""

    kind = "slam"
    rate_metric = "robot_scans_per_s"
    tail_metric = "step_ms_p95"

    def __init__(self, cell, seed: int, device):
        super().__init__()
        self.cell, self.seed, self.dev = cell, int(seed), device
        self.rcfg = reference_config(cell.config)
        self.cfg = program_config(cell.config["slam"])
        scans, laps, _ = fleet_streams(cell.traffic, seed, int(self.rcfg["n_max"]), device)
        self.feed = Feed(scans, laps, FEED_STEPS)
        self.units_per_call = int(scans.shape[0])
        self.warm = int(cell.traffic["warm_steps"])
        check = dict(cell.check, maintenance_interval=self.rcfg["maintenance_interval"], first_tick=self.warm)
        self.sampled = set(sampled_calls(check, seed))
        self.snaps: dict[int, dict] = {}
        self.trace_snaps: list[dict] = []
        first = self.feed(0)
        self.first = first
        self.init_program(first)
        for t in range(1, self.warm + 1):  # one lap: the maps a fleet server runs on
            self.step_program(self.feed(t), t - 1)

    def tick(self, i: int) -> int:
        return self.warm + i

    def scans(self, i: int) -> torch.Tensor:
        return self.feed(self.warm + 1 + i)

    def call(self, i: int) -> None:
        self.answers = self.step_program(self.scans(i), self.tick(i))

    def drop_traced(self) -> None:
        self.trace_snaps.clear()

    def layer_work(self) -> dict:
        """K1's counted work over the traced steps (`k1_work`), each step's
        registrations worked out again by the reference from its inputs."""
        ops = nbytes = 0.0
        for snap in self.trace_snaps:
            tr = ref.track_blocks(snap["scans"], snap["pose"], snap["prev_pose"], snap["map_xy"], snap["map_valid"],
                                  self.rcfg, _WORK)
            o, b = k1_work(tr.reg)
            ops, nbytes = ops + o, nbytes + b
        return {"k1_ops": ops, "k1_bytes": nbytes, "steps": len(self.trace_snaps)}


def k1_work(reg: ref.Registration) -> tuple[float, float]:
    """Least work of a batch of registrations: per robot the valid gated,
    voxelled source points ``s``, the local map's valid points ``t`` and the
    sweeps (its iterations and the residual pass), 2 operations a (source,
    target) pair a sweep; the bytes are those points read once, 8 a point."""
    s, t, it = (x.to(torch.float64) for x in (reg.n_src, reg.n_tgt, reg.iters))
    return float((2.0 * s * t * (it + 1)).sum()), float((8.0 * (s + t)).sum())


def robots_to_check(cell, seed: int, r: int) -> torch.Tensor:
    rng = np.random.default_rng([int(seed) % 2**63, 1])
    n = min(int(cell.check.get("robots", r)), r)
    return torch.as_tensor(np.sort(rng.choice(r, size=n, replace=False)))


def stop_witness(snap: dict, pose: torch.Tensor, tr: ref.Tracked, cfg: dict, n: int = 4,
                 program_iters: torch.Tensor | None = None) -> str:
    """Where the worst robots' registrations part from the reference: for
    the ``n`` robots registered on both sides whose poses lie farthest
    apart, the reference's iterations, the program's (where it reports
    them), and the iteration of the reference's path, run on past its stop,
    that lies nearest the program's pose, with that distance (mm)."""
    both = (tr.accepted & tr.enough).cpu()
    gap = torch.linalg.vector_norm(pose.cpu().to(torch.float64)[:, :2] - tr.reg.pose.cpu()[:, :2], dim=-1)
    gap = torch.where(both, gap, torch.full_like(gap, -1.0))
    worst = torch.argsort(gap, descending=True)[:n]
    worst = worst[gap[worst] >= 0]
    if not len(worst):
        return "no robot registered on both sides"
    dev = snap["scans"].device
    sub = worst.to(dev)
    shared = snap["map_xy"].dim() == 2
    _, _, _, icp_in = ref.track_inputs(snap["scans"][sub], snap["pose"][sub], snap["prev_pose"][sub],
                                       snap["map_xy"] if shared else snap["map_xy"][sub],
                                       snap["map_valid"] if shared else snap["map_valid"][sub], cfg, ref.F64)
    path = ref.icp_iterates(*icp_in, cfg["icp"], ref.F64)
    near = torch.linalg.vector_norm(path[:, :, :2] - pose[sub].to(torch.float64)[None, :, :2].to(dev), dim=-1)
    d, j = near.min(0)
    parts = []
    for k, r in enumerate(worst.tolist()):
        prog = "" if program_iters is None else f", program {int(program_iters[r])}"
        parts.append(f"robot {r}: gap {float(gap[r]):.3f} mm, reference {int(tr.reg.iters[r])} iterations{prog}, "
                     f"nearest reference iteration {int(j[k])} at {float(d[k]):.4f} mm")
    return "; ".join(parts)
