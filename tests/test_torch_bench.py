"""`cli bench` (`icp_slam_yolo_tpu_torch/bench.py`) on the CPU at small
sizes: the pair against the root ``bench.py``'s, the batched registrations
against JAX's ``vmap(icp_masked)``, the JSON line's keys against the root
``bench.py``'s, the plausibility guard, the command line, the FLOP count
against PyTorch's counter, and the synthetic scans' digest.  Nothing here
is timed on the card: the readings' values are the CPU's and are not
checked."""

import hashlib
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as root_bench
from conftest import REFERENCE_SCANS
from icp_slam_yolo_tpu.config import IcpConfig as JIcpConfig
from icp_slam_yolo_tpu.core.registration import icp_masked as jicp_masked
from icp_slam_yolo_tpu_torch import bench, cli
from icp_slam_yolo_tpu_torch.io import synthetic

torch.set_num_threads(2)

TINY = dict(batch=4, n_calls=2, pair_calls=3, baseline_repeats=5, seq_scans=6, fleet_robots=2, fleet_scans=4,
            single_scans=5, detect_calls=1, detect_b128=2, detect_b128_calls=1, fused_calls=2, train_batch=2,
            train_calls=1, img_size=64)

# the root bench.py's JSON line (`bench.py:533-637`): its keys, and its secondary readings with --all
ROOT_KEYS = ["metric", "value", "unit", "vs_baseline", "secondary", "protocol"]
ROOT_SECONDARY = [
    "single_pair_latency_ms", "single_pair_fixed50_ms", "sequence_scans_per_sec_offline_preset",
    "sequence_scans_per_sec_realtime_preset", "detect_gflop_per_image", "detect_flops_note", "detect_achieved_tflops",
    "detect_mfu", "detect_fps_640_b128", "detect_mfu_b128", "fleet_matched_single_scans_per_sec",
    "fused_ticks_per_sec", "fused_ticks_per_sec_triggered", "fused_slam_only_ticks_per_sec",
    "fused_detect_b2_only_ticks_per_sec", "train_steps_per_sec_b16_640", "train_steps_per_sec_f32_b16_640",
    "sequence_scans_per_sec", "detect_fps_640", "fleet_scans_per_sec", "baseline_cpu_reg_per_sec",
]

# sha256 of `synthetic_sequence(150, 0)` (scans' bytes, then the poses'), as chip_smoke.py generated them
# before the generator moved to io/synthetic.py
SYNTHETIC_150_0 = "5fb820eb9445adec4cf006c988293666863bbc84f6bbc66a6640904834348f02"


@pytest.fixture(scope="module")
def everything():
    """`bench.run` with every reading, on the CPU at tiny sizes."""
    return bench.run(all_readings=True, device="cpu", sizes=TINY)


def test_load_pair_equals_the_root_bench():
    """The pair is the root ``bench.py``'s, bit for bit (its ``_load_pair``
    reads only the JAX package's numpy modules): the recorded pair when the
    reference data is there, else the seeded wall pair."""
    src, tgt = root_bench._load_pair()
    scan_dir = REFERENCE_SCANS if os.path.isdir(REFERENCE_SCANS) else None
    got_src, got_tgt, data = bench.load_pair(scan_dir)
    assert data == ("Scan_data_1" if scan_dir else "synthetic")
    assert got_src.dtype == src.dtype and np.array_equal(got_src, src)
    assert got_tgt.dtype == tgt.dtype and np.array_equal(got_tgt, tgt)


def test_batched_registrations_match_jax_vmap():
    """The headline's first call (4 registrations, all 50 iterations) against
    JAX's ``vmap(icp_masked)`` with ``early_exit=False`` on the same inputs,
    through the JAX kernel K1 stands for (``backend="fused"``, the Pallas
    kernel in interpret mode): within 1e-3 mm and 1e-5 rad.  (JAX's XLA
    loop, its CPU default, stops 0.14 mm away on one of these: this pair
    has a flat valley and float32 rounding decides where a loop stops.)"""
    src, tgt, _ = bench.load_pair()
    _, got, inits = bench.bench_batched(src, tgt, batch=4, n_calls=1, device="cpu")
    s, sv, t, tv, init = (jnp.asarray(x.numpy()) for x in bench.batched_inputs(src, tgt, 4, "cpu"))
    np.testing.assert_array_equal(inits, np.asarray(init, np.float64))
    cfg = JIcpConfig(early_exit=False, backend="fused")
    want = np.asarray(jax.vmap(lambda a, b, c, d, e: jicp_masked(a, b, c, d, e, cfg))(s, sv, t, tv, init).pose)
    assert np.hypot(*(got[:, :2] - want[:, :2]).T).max() <= 1e-3
    assert np.abs(got[:, 2] - want[:, 2]).max() <= 1e-5


def test_line_holds_the_root_bench_keys(everything):
    line = everything["line"]
    assert set(ROOT_KEYS + ["data", "device"]) <= set(line)
    assert set(ROOT_SECONDARY) <= set(line["secondary"])
    assert line["metric"] == "icp_registrations_per_sec" and line["unit"] == "reg/s"
    assert line["protocol"] == bench.PROTOCOL and line["data"] == "synthetic" and line["device"] == "cpu"
    json.dumps(line)  # one JSON line
    assert all(n >= 5 for n in line["samples"].values())


def test_every_reading_has_a_bound_and_every_check_passed(everything):
    line, detail = everything["line"], everything["detail"]
    readings = [k for k, v in line["secondary"].items() if not isinstance(v, str)]
    derived = {"detect_gflop_per_image", "detect_achieved_tflops", "detect_mfu", "detect_mfu_b128",
               "baseline_cpu_reg_per_sec"}  # derived from a bounded reading, or the CPU's
    assert set(detail["bounds"]) == set(readings) - derived | {"icp_registrations_per_sec"}
    assert set(detail["bound_derivations"]) == set(detail["bounds"])
    assert all(math.isfinite(b) and b > 0 for b in detail["bounds"].values())
    assert "implausible_readings" not in line["secondary"]
    assert set(detail["checks"]) == {"registrations_match_oracle", "detections_finite", "sequences_accept",
                                     "train_losses_finite"}
    assert all(c["ok"] for c in detail["checks"].values())
    assert detail["sizes"]["warehouse"] == bench.WAREHOUSE
    fill = detail["sizes"]["map_points_of_slots"]
    assert set(fill) == {k for k in readings if k.startswith(("sequence_", "fleet_"))}
    assert all(0 < points <= slots for points, slots in fill.values())


def test_bounds_follow_from_the_work():
    work = {"n_src": 200, "n_tgt": 300, "converged_iters": 20, "state_bytes": {"sequence_scans_per_sec": 10 ** 6}}
    b = bench.bounds(work)
    assert b["icp_registrations_per_sec"] == pytest.approx(bench.PEAK_FP32 / (2 * 51 * 200 * 300))
    assert b["single_pair_latency_ms"] == pytest.approx(2 * 21 * 200 * 300 / bench.PEAK_FP32 * 1e3)
    assert b["sequence_scans_per_sec"] == pytest.approx(bench.PEAK_BYTES / (2 * 10 ** 6 + 512 * 12))


def test_guard_nulls_and_lists_readings_past_their_bounds():
    readings = {"detect_fps_640": 5e6, "fleet_scans_per_sec": 10.0, "single_pair_latency_ms": 1e-9,
                "single_pair_fixed50_ms": 0.5, "fleet_matched_single_scans_per_sec": {"point": 9e9, "range": [1, 2]}}
    limits = {"detect_fps_640": 1e6, "fleet_scans_per_sec": 1e3, "single_pair_latency_ms": 1e-6,
              "single_pair_fixed50_ms": 1e-6, "fleet_matched_single_scans_per_sec": 1e3}
    out = bench.guard_implausible(readings, limits)
    assert out["detect_fps_640"] is None and out["single_pair_latency_ms"] is None
    assert out["fleet_matched_single_scans_per_sec"] is None
    assert out["fleet_scans_per_sec"] == 10.0 and out["single_pair_fixed50_ms"] == 0.5
    assert out["implausible_readings"] == {
        "detect_fps_640": {"value": 5e6, "bound": 1e6},
        "single_pair_latency_ms": {"value": 1e-9, "bound": 1e-6},
        "fleet_matched_single_scans_per_sec": {"value": 9e9, "bound": 1e3},
    }


def test_headline_past_its_bound_raises(monkeypatch):
    monkeypatch.setattr(bench, "PEAK_FP32", 1.0)  # a roof of well under one registration a second
    with pytest.raises(bench.BenchFailed, match="headline implausible"):
        bench.run(False, device="cpu", sizes=TINY)


def test_cli_bench_help_and_device_rule(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--all" in out and "--device" in out
    if torch.cuda.is_available():
        pytest.skip("a card is present: cli bench would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        cli.main(["bench"])


def test_cli_bench_prints_the_line_and_fails_on_a_check(monkeypatch, capsys, tmp_path):
    line = {"metric": "icp_registrations_per_sec", "value": 1.0}
    seen = {}

    def fake_run(all_readings, device, scan_dir):
        seen.update(all_readings=all_readings, device=device, scan_dir=scan_dir)
        return {"line": line, "detail": {}}

    monkeypatch.setattr(bench, "run", fake_run)
    cli.main(["bench", "--device", "cpu", "--scan-dir", str(tmp_path)])
    assert seen == {"all_readings": False, "device": "cpu", "scan_dir": str(tmp_path)}
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == line

    def failing_run(*args):
        raise bench.BenchFailed("checks failed: ['train_losses_finite']")

    monkeypatch.setattr(bench, "run", failing_run)
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--device", "cpu"])
    assert "train_losses_finite" in str(e.value.code)


@pytest.mark.parametrize("family", ["v8", "v12"])
def test_forward_flops_equal_pytorchs_count(family):
    """The count from conv and attention shapes equals PyTorch's own FLOP
    counter on a real forward (64 px, batch 1)."""
    from torch.utils.flop_counter import FlopCounterMode

    from icp_slam_yolo_tpu_torch.models.yolo import YOLO

    model = YOLO(num_classes=1, family=family, fold_bn=True)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.rand(1, 64, 64, 3))
    assert bench.forward_flops(model, 64) == counter.get_total_flops()


def test_synthetic_sequence_digest_unchanged_by_the_move():
    scans, poses = synthetic.synthetic_sequence(150, 0)
    h = hashlib.sha256()
    h.update(scans.tobytes())
    h.update(poses.tobytes())
    assert h.hexdigest() == SYNTHETIC_150_0


def test_static_import_check_covers_the_bench_modules():
    from test_torch_cli import _sources

    rel = {os.path.relpath(p, os.path.dirname(os.path.dirname(__file__))) for p in _sources()}
    for f in ("bench.py", "io/synthetic.py", "reference_impl/__init__.py", "reference_impl/oracle.py"):
        assert os.path.join("icp_slam_yolo_tpu_torch", f) in rel
