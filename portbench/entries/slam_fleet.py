"""Independent robots, one step a tick for all of them:
`parallel.fleet.make_fleet_step` on the configuration, every robot's pose
and accept flag read back after each step.

The check: at the sampled steps, every robot's pose and accept flag against
the reference's step from the same state, and for a sample of robots the
map and the grid the step left; the start (`fleet_init`) likewise.
"""

from __future__ import annotations

import sys
import time

import torch

from portbench import judge as J
from portbench.entries._slam import SlamSession, read_answers, robots_to_check, stop_witness
from portbench.harness import Check
from portbench.reference import slam as ref


# what `judge` compares, each with a limit in the cell file
NUMBERS = ("pose_gap_mm", "heading_gap_rad", "accept_flips", "map_mismatch", "grid_mismatch")


class FleetSession(SlamSession):

    def init_program(self, first):
        from icp_slam_yolo_tpu_torch.parallel import fleet

        self.step_fn = fleet.make_fleet_step(self.cfg)
        self.state = fleet.fleet_init(first, self.cfg)
        self.robots = robots_to_check(self.cell, self.seed, first.shape[0]).to(first.device)
        s = self.state
        self.init_snap = {"map_xy": s.map_xy[self.robots], "map_valid": s.map_valid[self.robots],
                          "occ": s.occ[self.robots].clone()}

    def step_program(self, scans, tick):
        t0 = time.perf_counter()
        self.state, out, _ = self.step_fn(self.state, scans, tick)
        self.dispatch_s.append(time.perf_counter() - t0)
        self.iters = out.n_iters
        return read_answers(out.pose, out.accepted)

    def before(self, i: int, traced: bool = False) -> None:
        if i not in self.sampled and not traced:
            return
        s = self.state
        snap = {"scans": self.scans(i), "tick": self.tick(i), "pose": s.pose, "prev_pose": s.prev_pose,
                "map_xy": s.map_xy, "map_valid": s.map_valid}
        if traced:
            self.trace_snaps.append(snap)
        if i in self.sampled:
            sub = self.robots
            snap.update(occ=s.occ[sub].clone(), prev_xy=s.prev_xy[sub], prev_valid=s.prev_valid[sub])
            self.snaps[i] = snap

    def after(self, i: int) -> None:
        if i in self.sampled:
            s, sub = self.state, self.robots
            self.snaps[i].update(answers=self.answers, new_map_xy=s.map_xy[sub], new_map_valid=s.map_valid[sub],
                                 new_occ=s.occ[sub].clone(), iters=self.iters.cpu())

    def release(self) -> None:
        self.state = self.feed = None

    def judge(self, control: bool = False) -> list[Check]:
        """The program's answers (``control``: the reference's in TF32,
        from the same states) against the reference's in float64."""
        lim = self.cell.limits
        cfg, sub = self.rcfg, self.robots
        t0 = time.perf_counter()
        worst = {"pose_gap_mm": 0.0, "heading_gap_rad": 0.0, "accept_flips": 0}
        map_bad = map_of = grid_bad = grid_of = 0
        for i in sorted(self.snaps):
            snap = self.snaps[i]
            if "answers" not in snap:
                continue  # the window closed before this step
            tr = ref.track_blocks(snap["scans"], snap["pose"], snap["prev_pose"], snap["map_xy"], snap["map_valid"],
                                  cfg, ref.F64)
            pose64 = snap["pose"].to(torch.float64)
            ref_pose = torch.where(tr.enough[:, None], torch.where(tr.accepted[:, None], tr.reg.pose, pose64), pose64)
            old = ref.RobotState(snap["pose"][sub], snap["prev_pose"][sub], snap["map_xy"][sub],
                                 snap["map_valid"][sub], snap["occ"], snap["prev_xy"], snap["prev_valid"])
            tr_sub = ref.Tracked(tr.xy[sub], tr.valid[sub], tr.enough[sub], ref.Registration(*(f[sub] for f in tr.reg)),
                                 tr.accepted[sub])
            new_ref = ref.fleet_update(old, tr_sub, snap["tick"], cfg, ref.F64)
            if control:
                tc = ref.track_blocks(snap["scans"], snap["pose"], snap["prev_pose"], snap["map_xy"],
                                      snap["map_valid"], cfg, ref.TF32)
                p32 = snap["pose"].to(torch.float32)
                pose = torch.where(tc.enough[:, None], torch.where(tc.accepted[:, None], tc.reg.pose, p32), p32)
                flags = tc.accepted
                tc_sub = ref.Tracked(tc.xy[sub], tc.valid[sub], tc.enough[sub],
                                     ref.Registration(*(f[sub] for f in tc.reg)), tc.accepted[sub])
                new = ref.fleet_update(old, tc_sub, snap["tick"], cfg, ref.TF32)
                new_map, new_valid, new_occ = new.map_xy, new.map_valid, new.occ
            else:
                ans = snap["answers"].to(ref_pose.device)
                pose, flags = ans[:, :3], ans[:, 3] > 0.5
                new_map, new_valid, new_occ = snap["new_map_xy"], snap["new_map_valid"], snap["new_occ"]
                print(f"stop witness, step {i}: {stop_witness(snap, pose, tr, cfg, program_iters=snap['iters'])}",
                      file=sys.stderr)
            gap, turn = J.pose_gaps(pose, ref_pose)
            worst["pose_gap_mm"] = max(worst["pose_gap_mm"], gap)
            worst["heading_gap_rad"] = max(worst["heading_gap_rad"], turn)
            worst["accept_flips"] += J.flag_flips(flags, tr.accepted)
            b, f = J.map_mismatch(new_map, new_valid, new_ref.map_xy, new_ref.map_valid, old.map_xy, old.map_valid)
            map_bad, map_of = map_bad + b, map_of + f
            b, f = J.grid_mismatch(new_occ, new_ref.occ, old.occ)
            grid_bad, grid_of = grid_bad + b, grid_of + f
        # the start, checked by itself
        init_ref = ref.fleet_init(self.first[sub], cfg, ref.F64)
        if control:
            init = ref.fleet_init(self.first[sub], cfg, ref.TF32)
            init_map, init_valid, init_occ = init.map_xy, init.map_valid, init.occ
        else:
            init_map, init_valid, init_occ = (self.init_snap[k] for k in ("map_xy", "map_valid", "occ"))
        empty = torch.zeros_like(init_ref.map_valid)
        b, f = J.map_mismatch(init_map, init_valid, init_ref.map_xy, init_ref.map_valid, init_ref.map_xy, empty)
        map_bad, map_of = map_bad + b, map_of + f
        b, f = J.grid_mismatch(init_occ, init_ref.occ, torch.full_like(init_ref.occ, 0.5))
        grid_bad, grid_of = grid_bad + b, grid_of + f
        print(f"reference check: {len(self.snaps)} steps, {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        values = dict(worst, map_mismatch=J.share(map_bad, map_of), grid_mismatch=J.share(grid_bad, grid_of))
        return [Check(k, float(v), float(lim.get(k, 0.0))) for k, v in values.items()]


def setup(cell, seed: int, device) -> FleetSession:
    return FleetSession(cell, seed, device)
