"""Robots building one map: `parallel.shared.make_shared_step` on the
configuration, every robot's pose and accept flag read back after each
step.

The check: at the sampled steps, every robot's pose and accept flag, the
shared map and the merged grid against the reference's step from the same
state; the start (`shared_init`) likewise.
"""

from __future__ import annotations

import sys
import time

import torch

from portbench import judge as J
from portbench.entries._slam import SlamSession, read_answers, stop_witness
from portbench.harness import Check
from portbench.reference import slam as ref


# what `judge` compares, each with a limit in the cell file
NUMBERS = ("pose_gap_mm", "heading_gap_rad", "accept_flips", "map_mismatch", "grid_mismatch")


class SharedSession(SlamSession):

    def init_program(self, first):
        from icp_slam_yolo_tpu_torch.parallel import shared

        self.step_fn = shared.make_shared_step(self.cfg)
        self.state = shared.shared_init(first, self.cfg)
        self.init_snap = self.state

    def step_program(self, scans, tick):
        t0 = time.perf_counter()
        self.state, (pose, _, accepted) = self.step_fn(self.state, scans, tick)
        self.dispatch_s.append(time.perf_counter() - t0)
        return read_answers(pose, accepted)

    def before(self, i: int, traced: bool = False) -> None:
        if i not in self.sampled and not traced:
            return
        s = self.state  # the step leaves its input state as it was
        snap = {"scans": self.scans(i), "tick": self.tick(i), "state": s, "pose": s.pose, "prev_pose": s.prev_pose,
                "map_xy": s.map_xy, "map_valid": s.map_valid}
        if traced:
            self.trace_snaps.append(snap)
        if i in self.sampled:
            self.snaps[i] = snap

    def after(self, i: int) -> None:
        if i in self.sampled:
            self.snaps[i].update(answers=self.answers, new=self.state)

    def release(self) -> None:
        self.state = self.feed = None

    def judge(self, control: bool = False) -> list[Check]:
        """The program's answers (``control``: the reference's in TF32,
        from the same states) against the reference's in float64."""
        lim, cfg = self.cell.limits, self.rcfg
        t0 = time.perf_counter()
        worst = {"pose_gap_mm": 0.0, "heading_gap_rad": 0.0, "accept_flips": 0}
        map_bad = map_of = grid_bad = grid_of = 0
        for i in sorted(self.snaps):
            snap = self.snaps[i]
            if "answers" not in snap:
                continue  # the window closed before this step
            s = snap["state"]
            old = ref.SharedState(s.map_xy, s.map_valid, s.occ, s.pose, s.prev_pose, s.prev_xy, s.prev_valid)
            new_ref, tr = ref.shared_step(old, snap["scans"], snap["tick"], cfg, ref.F64)
            if control:
                new, tc = ref.shared_step(old, snap["scans"], snap["tick"], cfg, ref.TF32)
                pose, flags = new.pose, tc.accepted
            else:
                ans = snap["answers"].to(new_ref.pose.device)
                pose, flags, new = ans[:, :3], ans[:, 3] > 0.5, snap["new"]
                print(f"stop witness, step {i}: {stop_witness(snap, pose, tr, cfg)}", file=sys.stderr)
            gap, turn = J.pose_gaps(pose, new_ref.pose)
            worst["pose_gap_mm"] = max(worst["pose_gap_mm"], gap)
            worst["heading_gap_rad"] = max(worst["heading_gap_rad"], turn)
            worst["accept_flips"] += J.flag_flips(flags, tr.accepted)
            b, f = J.map_mismatch(new.map_xy[None], new.map_valid[None], new_ref.map_xy[None],
                                  new_ref.map_valid[None], s.map_xy[None], s.map_valid[None])
            map_bad, map_of = map_bad + b, map_of + f
            b, f = J.grid_mismatch(new.occ, new_ref.occ, s.occ)
            grid_bad, grid_of = grid_bad + b, grid_of + f
        # the start, checked by itself
        init_ref = ref.shared_init(self.first, cfg, ref.F64)
        init = ref.shared_init(self.first, cfg, ref.TF32) if control else self.init_snap
        empty = torch.zeros_like(init_ref.map_valid)[None]
        b, f = J.map_mismatch(init.map_xy[None], init.map_valid[None], init_ref.map_xy[None],
                              init_ref.map_valid[None], init_ref.map_xy[None], empty)
        map_bad, map_of = map_bad + b, map_of + f
        b, f = J.grid_mismatch(init.occ, init_ref.occ, torch.full_like(init_ref.occ, 0.5))
        grid_bad, grid_of = grid_bad + b, grid_of + f
        print(f"reference check: {len(self.snaps)} steps, {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        values = dict(worst, map_mismatch=J.share(map_bad, map_of), grid_mismatch=J.share(grid_bad, grid_of))
        return [Check(k, float(v), float(lim.get(k, 0.0))) for k, v in values.items()]


def setup(cell, seed: int, device) -> SharedSession:
    return SharedSession(cell, seed, device)
