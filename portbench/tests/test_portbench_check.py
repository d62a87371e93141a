"""The check's control and faults, driven through the rest of a run on the
CPU at a size a test run holds (the look for a card skipped): the program
as it is comes out correct; the reference in the precision below the
configuration's (TF32 for the SLAM step, float8 for the detector) and a
program broken underneath the timed path come out not correct."""

import copy

import pytest
import torch

from portbench import run as harness
from portbench.spec import entry_module, load_cell

SEED = 2**31 + 99


def small(name: str):
    cell = load_cell(name)
    traffic, check, config = dict(cell.traffic), dict(cell.check), copy.deepcopy(cell.config)
    if cell.entry.startswith("slam"):
        traffic.update(robots=4, warm_steps=9)
        check.update(within=3, robots=2)
        config["slam"].update(map_capacity=2048, local_map_capacity=2048)
    else:
        traffic.update(batch=4, pool=2, warm_calls=1)
        check.update(within=3)
        config.update(img_size=128)
    return cell._replace(traffic=traffic, check=check, config=config)


def run_small(name: str):
    line, checks = harness.run(small(name), SEED, 0.0, False, torch.device("cpu"), [], [])
    return line


def _break_fleet(monkeypatch, how):
    from icp_slam_yolo_tpu_torch.parallel import fleet

    real = fleet.make_fleet_step

    def make(cfg, mesh=None):
        step = real(cfg, mesh)

        def broken(states, scans, tick=None):
            if how == "unchanged":
                _, out, stats = step(states, scans, tick)
                return states, out._replace(pose=states.pose), stats
            if how == "half":
                h = scans.shape[0] // 2
                new, out, stats = step(type(states)(*(x[:h] for x in states)), scans[:h], tick)
                merged = type(states)(*(torch.cat([a, b[h:]]) for a, b in zip(new, states)))
                return merged, type(out)(*(torch.cat([a, a[: scans.shape[0] - h]]) for a in out)), stats
            new, out, stats = step(states, scans, tick)
            pose = out.pose.clone()
            pose[0, 0] += 1000.0
            return new, out._replace(pose=pose), stats

        return broken

    monkeypatch.setattr(fleet, "make_fleet_step", make)


def _break_shared(monkeypatch, how):
    from icp_slam_yolo_tpu_torch.parallel import shared

    real = shared.make_shared_step

    def make(cfg, mesh=None):
        step = real(cfg, mesh)

        def broken(state, scans, tick):
            if how == "unchanged":
                _, (pose, rmse, acc) = step(state, scans, tick)
                return state, (state.pose, rmse, acc)
            if how == "half":
                h = scans.shape[0] // 2
                sub = state._replace(pose=state.pose[:h], prev_pose=state.prev_pose[:h], prev_xy=state.prev_xy[:h],
                                     prev_valid=state.prev_valid[:h])
                new, out = step(sub, scans[:h], tick)
                r = scans.shape[0] - h
                new = new._replace(**{f: torch.cat([getattr(new, f), getattr(state, f)[h:]])
                                      for f in ("pose", "prev_pose", "prev_xy", "prev_valid")})
                return new, tuple(torch.cat([a, a[:r]]) for a in out)
            new, (pose, rmse, acc) = step(state, scans, tick)
            pose = pose.clone()
            pose[0, 0] += 1000.0
            return new, (pose, rmse, acc)

        return broken

    monkeypatch.setattr(shared, "make_shared_step", make)


def _break_detector(monkeypatch, how):
    from icp_slam_yolo_tpu_torch.models import detect

    real = detect.Detector.predict_batch
    last = {}

    def broken(self, images):
        if how == "unchanged":  # the previous call's answers
            dets = real(self, images)
            stale, last["dets"] = last.get("dets", dets), dets
            return stale
        if how == "half":
            h = images.shape[0] // 2
            dets = real(self, images[:h])
            return type(dets)(*(torch.cat([a, a[: images.shape[0] - h]]) for a in dets))
        dets = real(self, images)  # the batch's boxes produced 100 px off
        return dets._replace(boxes=dets.boxes + 100.0)

    monkeypatch.setattr(detect.Detector, "predict_batch", broken)


BREAK = {"fleet-b256": _break_fleet, "shared-r256": _break_shared, "detect-b32": _break_detector}


@pytest.mark.parametrize("name", ["fleet-b256", "shared-r256", "detect-b32"])
def test_sound_program_is_correct(name):
    line = run_small(name)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("name", ["fleet-b256", "shared-r256", "detect-b32"])
def test_control_is_not_correct(name):
    cell = small(name)
    session = entry_module(cell).setup(cell, SEED, torch.device("cpu"))
    for i in range(4):
        session.before(i)
        session.call(i)
        session.after(i)
    session.release()
    checks = session.judge(control=True)
    assert not all(c.ok for c in checks), checks


@pytest.mark.parametrize("how", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", ["fleet-b256", "shared-r256", "detect-b32"])
def test_fault_is_not_correct(name, how, monkeypatch):
    BREAK[name](monkeypatch, how)
    line = run_small(name)
    assert not line["correct"], line["checks"]


def test_half_stride_decode_is_not_correct(monkeypatch):
    """Every box decoded half its anchor's stride off, right and down: the
    head and the detections' overlaps still pass, the boxes' gap does not."""
    from portbench.reference import yolo
    from icp_slam_yolo_tpu_torch.models import detect

    real = detect.Detector.predict_batch

    def shifted(self, images):
        dets = real(self, images)
        _, strides = yolo.anchors(images.shape[1], dets.boxes.device)
        return dets._replace(boxes=dets.boxes + 0.5 * strides[dets.anchor_idx.long()][..., None])

    monkeypatch.setattr(detect.Detector, "predict_batch", shifted)
    line = run_small("detect-b32")
    assert not line["correct"], line["checks"]
    assert not (line["checks"]["box_mismatch"]["value"] <= line["checks"]["box_mismatch"]["limit"])


def test_traced_run_reads_its_metrics(monkeypatch):
    """A ``--trace 1`` run on the CPU with the profiler's window faked: the
    slice, the entry's work count and every reader of the cell run."""
    from portbench import trace

    def fake(fn, device):
        fn()
        kernels = [trace.Event("icp_kernel(IcpArgs)", 0.0, 400.0), trace.Event("raster_kernel<true>", 500.0, 520.0)]
        return trace.Trace(kernels, [trace.Event("aten::sort", 400.0, 500.0)], 1000.0, 420.0)

    monkeypatch.setattr(trace, "traced", fake)
    e2e, per_layer, _ = harness.cell_metrics("fleet-b256")
    line, _ = harness.run(small("fleet-b256"), SEED, 0.0, True, torch.device("cpu"), e2e, per_layer)
    assert set(line["metrics"]) == {m["name"] for m in per_layer}
    assert line["metrics"]["idle_share.slam"]["value"] == pytest.approx(58.0)
    assert line["breakdown"]["idle_gaps"] == [["aten::sort", 0.0001]]
