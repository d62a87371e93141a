"""The port's stage spans (`utils/profiling.span`): free and silent while no
profiler collects, ordinary CPU events of the profiler's trace while one
does, one of each stage a SLAM or detector call, the same outputs either
way; and the benchmark's readers of them (`portbench/metrics/`) on
hand-made records.  CPU, at small sizes; the last test needs a CUDA card
and skips without one."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from icp_slam_yolo_tpu_torch import config as tc
from icp_slam_yolo_tpu_torch.io.synthetic import synthetic_sequence
from icp_slam_yolo_tpu_torch.models import detect as tdetect
from icp_slam_yolo_tpu_torch.ops import nms as tnms
from icp_slam_yolo_tpu_torch.parallel import fleet, shared
from icp_slam_yolo_tpu_torch.utils import profiling
from icp_slam_yolo_tpu_torch.utils.profiling import span

torch.set_num_threads(2)

STAGES = ("slam.gate", "slam.outlier", "slam.target", "slam.register", "slam.update")
UPDATE = ("slam.filter", "slam.occupancy", "slam.compact")
MAINTAIN_TICK = tc.MAP_MAINTENANCE_INTERVAL - 1  # (tick + 1) % interval == 0


@pytest.fixture(autouse=True)
def _no_records():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _small_fleet():
    """The ``fleet`` preset on a 384 x 384 grid, 1024 map slots, 10 ICP
    iterations (as `test_torch_fleet.py` cuts it)."""
    cfg = tc.FLEET_CONFIG
    return cfg.replace(map=tc.MapConfig(width_mm=11520.0, height_mm=11520.0),
                       occupancy=dataclasses.replace(cfg.occupancy, window_px=100, max_ray_px=112),
                       map_capacity=1024, local_map_capacity=1024,
                       icp=dataclasses.replace(cfg.icp, max_iterations=10))


def _scans(n_scans=3, robots=2, n_max=512):
    """``(robots, n_scans, n_max, 3)`` seeded streams in a 10 m x 8 m hall."""
    out = np.zeros((robots, n_scans, n_max, 3), np.float32)
    for b in range(robots):
        s, _ = synthetic_sequence(n_scans, seed=7 + b, half_x=5000.0, half_y=4000.0, path_half_x=2500.0,
                                  path_half_y=1500.0, radius=1000.0)
        out[b, :, : s.shape[1]] = s
    return torch.from_numpy(out)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _tree(recs):
    """``{name: parent name}`` of the records, each name once."""
    names = [r.name for r in recs]
    assert len(names) == len(set(names)), names
    return {r.name: (r.parent.name if r.parent is not None else None) for r in recs}


def _fleet_step(cfg, scans, tick):
    step = fleet.make_fleet_step(cfg)
    states = fleet.fleet_init(scans[:, 0], cfg)
    return lambda: step(states, scans[:, 1], tick)


def _shared_step(cfg, scans, tick):
    step = shared.make_shared_step(cfg)
    state = shared.shared_init(scans[:, 0], cfg)
    return lambda: step(state, scans[:, 1], tick)


# ------------------------------------------------------------------ the primitive

def test_span_off_records_nothing_and_opens_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while no profiler collects")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(profiling.Span, "__init__", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    a, b = span("slam.step", torch.device("cpu")), span("slam.gate")
    assert a is b  # one shared object: nothing is allocated
    with a:
        with b:
            span.count("rounds", 3)
    assert profiling.spans() == []


def test_spans_are_nested_cpu_events_of_the_trace():
    def work():
        with span("slam.step", torch.device("cpu")):
            with span("slam.gate"):
                torch.ones(8) + 1
            with span("slam.update"):
                with span("slam.filter"):
                    span.count("reads", 2)
                    span.count("reads")
                    torch.ones(8) * 2

    _, prof = _profiled(work)
    recs = profiling.spans()
    assert [r.name for r in recs] == ["slam.gate", "slam.filter", "slam.update", "slam.step"]  # as they closed
    assert _tree(recs) == {"slam.step": None, "slam.gate": "slam.step", "slam.update": "slam.step",
                           "slam.filter": "slam.update"}
    assert recs[1].counts == {"reads": 3} and recs[3].counts == {}
    assert all(r.start is None and r.end is None and r.device_ms() is None for r in recs)  # no card, no interval
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for name in ("slam.step", "slam.gate", "slam.update", "slam.filter"):
        e = events[name]
        assert e.device_type() == torch.autograd.DeviceType.CPU and not e.is_user_annotation()
    parents = {fe.name: fe.cpu_parent.name if fe.cpu_parent is not None else None
               for fe in prof.profiler.function_events if fe.name.startswith("slam.")}
    assert parents == {"slam.step": None, "slam.gate": "slam.step", "slam.update": "slam.step",
                       "slam.filter": "slam.update"}
    for inner, outer in (("slam.gate", "slam.step"), ("slam.filter", "slam.update")):
        i, o = events[inner], events[outer]
        assert o.start_ns() <= i.start_ns() and i.start_ns() + i.duration_ns() <= o.start_ns() + o.duration_ns()


def test_trace_empties_the_records(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with span("slam.step"):
            pass
    assert len(profiling.spans()) == 1
    with profiling.trace(str(tmp_path / "tr")):
        assert profiling.spans() == []  # emptied on entry
        with span("detect.batch"):
            pass
        assert [r.name for r in profiling.spans()] == ["detect.batch"]
    assert profiling.spans() == []  # and on exit
    (written,) = list((tmp_path / "tr").iterdir())
    assert "detect.batch" in written.read_text()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("slam.step"):
            pass
    profiling.clear_spans()
    assert profiling.spans() == []


def test_records_are_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with span(f"slam.s{i}"):
                pass
    assert [r.name for r in profiling.spans()] == ["slam.s0", "slam.s1", "slam.s2"]


def test_span_intervals_chain_on_one_stream(monkeypatch):
    """One timing event a span's exit and one at the root's entry: a child
    starts where its parent had got to (the parent's start or the last
    sibling's exit)."""
    made = []
    monkeypatch.setattr(profiling.Span, "_event", lambda self: made.append(object()) or made[-1])
    stream = object()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.Span("slam.step", None, torch.device("cuda", 0), stream):
            with span("slam.gate"):
                pass
            with span("slam.update"):
                with span("slam.filter"):
                    pass
                with span("slam.occupancy"):
                    pass
    gate, flt, occ, update, step = profiling.spans()
    assert len(made) == 6 and step.start is made[0] and step.end is made[5]
    assert gate.start is step.start and update.start is gate.end and flt.start is update.start
    assert occ.start is flt.end and update.end is not occ.end and step.end is not update.end
    assert all(r.stream is stream for r in (gate, flt, occ, update))


# ------------------------------------------------------------------ the SLAM steps

@pytest.mark.parametrize("make", [_fleet_step, _shared_step], ids=["fleet", "shared"])
@pytest.mark.parametrize("tick", [0, MAINTAIN_TICK], ids=["plain", "maintenance"])
def test_slam_step_gives_each_stage_once(make, tick):
    _profiled(make(_small_fleet(), _scans(), tick))
    tree = _tree(profiling.spans())
    want = {"slam.step": None, **{s: "slam.step" for s in STAGES}, **{s: "slam.update" for s in UPDATE}}
    if tick == MAINTAIN_TICK:
        want["slam.maintain"] = "slam.update"
    assert tree == want


@pytest.mark.parametrize("make", [_fleet_step, _shared_step], ids=["fleet", "shared"])
def test_slam_stages_cover_the_step_on_the_host(make):
    """The top-level stages' host events cover 95 % of slam.step's: the
    step's work lies under its stages."""
    _, prof = _profiled(make(_small_fleet(), _scans(), MAINTAIN_TICK))
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("slam.")]
    (step,) = [e for e in events if e.name() == "slam.step"]
    top = sum(e.duration_ns() for e in events if e.name() in STAGES)
    assert 0.95 * step.duration_ns() <= top <= step.duration_ns()


@pytest.mark.parametrize("make", [_fleet_step, _shared_step], ids=["fleet", "shared"])
def test_slam_outputs_equal_with_spans_on_and_off(make):
    """The same state and scans through the step twice, traced and not (a
    fleet state is stepped in place, so each run gets its own)."""
    cfg, scans = _small_fleet(), _scans()
    off = make(cfg, scans, MAINTAIN_TICK)()
    on, _ = _profiled(make(cfg, scans, MAINTAIN_TICK))
    assert len(profiling.spans()) == 1 + len(STAGES) + len(UPDATE) + 1
    flat_off, flat_on = torch.utils._pytree.tree_leaves(off), torch.utils._pytree.tree_leaves(on)
    assert len(flat_off) == len(flat_on) >= 10
    for a, b in zip(flat_off, flat_on):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ the detector

def _detector():
    return tdetect.Detector(img_size=64, device="cpu", compute_dtype=torch.float32, conf_threshold=0.001)


def test_predict_batch_gives_the_detector_spans_and_the_same_detections():
    det = _detector()
    images = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    off = det.predict_batch(images)
    on, _ = _profiled(lambda: det.predict_batch(images))
    recs = profiling.spans()
    assert _tree(recs) == {"detect.batch": None, "detect.forward": "detect.batch", "detect.decode": "detect.batch",
                           "detect.nms": "detect.batch"}
    counts = next(r.counts for r in recs if r.name == "detect.nms")
    assert counts["reads"] >= 1 and counts["reads"] <= counts["rounds"] <= tnms.ROUNDS_PER_CHECK * counts["reads"]
    assert int(off.valid.sum()) > 0
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def _chain(n):
    """Box i overlaps only boxes i - 1 and i + 1, scores falling."""
    x0 = torch.arange(n, dtype=torch.float32) * 6
    boxes = torch.stack([x0, torch.zeros(n), x0 + 10, torch.full((n,), 10.0)], dim=1)[None]
    scores = torch.linspace(0.9, 0.3, n)[None]
    return boxes, scores, torch.zeros((1, n), dtype=torch.int32)


@pytest.mark.parametrize("n, per_check, rounds, reads", [
    (3, 4, 3, 1),     # fixed after 2 rounds: the group of 3 (K) and its one read
    (3, 1, 3, 3),     # one read a round: changed, changed, same
    (12, 4, 12, 3),   # the chain needs every round; the loop stops at K
    (12, 1, 12, 12),
])
def test_nms_counts_its_rounds_and_reads(n, per_check, rounds, reads, monkeypatch):
    monkeypatch.setattr(tnms, "ROUNDS_PER_CHECK", per_check)
    boxes, scores, classes = _chain(n)
    reads_made = []
    real_equal = torch.equal
    monkeypatch.setattr(torch, "equal", lambda a, b: reads_made.append(1) or real_equal(a, b))

    def run():
        with span("detect.nms"):
            return tnms.suppress(boxes, scores, classes, torch.arange(n, dtype=torch.int32)[None], scores > 0, 0.2)

    dets, _ = _profiled(run)
    assert dets.valid[0].tolist() == [i % 2 == 0 for i in range(n)]
    (rec,) = profiling.spans()
    assert rec.counts == {"rounds": rounds, "reads": reads} and len(reads_made) == reads


# ------------------------------------------------------------------ the benchmark's readers

class _Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def _record(name, parent, ms=None, **counts):
    r = profiling.Span(name, parent, None, None)
    if ms is not None:
        r.start, r.end = _Event(0.0), _Event(ms)
    r.counts.update(counts)
    return r


# Hand-made calls 1000 us apart on the trace's clock: the host opens each
# root at 0 and records its entry event at 1-2 (the anchor: call 0's entry
# event lies at 2), device operations run at KERNELS, and the stages'
# intervals lie at STAGE_TIMES (us from the call's start).
KERNELS = [(10, 20), (25, 60), (70, 75), (80, 400)]
STAGE_TIMES = {"slam.outlier": (12, 32), "slam.register": (32, 72), "slam.occupancy": (72, 90),
               "detect.nms": (50, 100)}  # busy 8 + 7, 28 + 2, 3 + 10, 10 + 5 + 20 us


def _ctx(kind, traced, calls=None, records=True):
    """The cell's context, with a trace of ``calls`` hand-made calls."""
    from types import SimpleNamespace

    from portbench.trace import Event, Trace

    calls = traced if calls is None else calls
    host, kernels = [], []
    for i in range(calls):
        t = 1000.0 * i
        host.append(Event({"slam": "slam.step", "detect": "detect.batch"}[kind], t, t + 900.0))
        if records:
            host.append(Event("cudaEventRecordWithFlags", t + 1.0, t + 2.0))
        kernels += [Event("k", t + a, t + b) for a, b in KERNELS]
    return SimpleNamespace(kind=kind, traced=traced, trace=Trace(kernels, host, 1000.0 * calls, 0.0))


def _at(i, name):
    """A record of call ``i``'s stage ``name``: its events in ms after call
    0's entry event (at 2 us)."""
    a, b = STAGE_TIMES[name] if name in STAGE_TIMES else (2.0, 900.0)
    return (1000.0 * i + a - 2.0) / 1e3, (1000.0 * i + b - 2.0) / 1e3


def _timed(name, parent, i, **counts):
    r = _record(name, parent, **counts)
    a, b = _at(i, name)
    r.start, r.end = _Event(a), _Event(b)
    return r


def _slam_records(steps):
    recs = []
    for i in range(steps):
        root = _timed("slam.step", None, i)
        update = _record("slam.update", root, 3.0)
        recs += [_timed("slam.outlier", root, i), _timed("slam.register", root, i),
                 _timed("slam.occupancy", update, i), update, root]
    return recs


def _detect_records(batches):
    recs = []
    for i in range(batches):
        root = _timed("detect.batch", None, i)
        recs += [_timed("detect.nms", root, i, rounds=4 * (i + 1), reads=i + 1), root]
    return recs


# device operations' ms a call inside each stage's interval
READERS = {"outlier_ms_per_step.slam": ("slam", 0.015), "register_ms_per_step.slam": ("slam", 0.030),
           "occupancy_ms_per_step.slam": ("slam", 0.013), "nms_ms_per_batch.detect": ("detect", 0.035),
           "nms_rounds_per_batch.detect": ("detect", 6.0)}


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_readers(name, monkeypatch):
    from portbench.spec import metric_reader

    read = metric_reader(name).read
    kind, want = READERS[name]
    recs = {"slam": _slam_records(3), "detect": _detect_records(2)}
    traced = {"slam": 3, "detect": 2}
    other = "detect" if kind == "slam" else "slam"
    monkeypatch.setattr(profiling, "spans", lambda: list(recs[kind]))
    assert read(_ctx(kind, traced[kind])) == pytest.approx(want)
    assert read(_ctx(other, traced[kind])) is None          # the other kind of cell
    assert read(_ctx(kind, traced[kind] + 1)) is None       # roots not the traced calls one for one
    if "rounds" not in name:
        assert read(_ctx(kind, traced[kind], calls=traced[kind] - 1)) is None  # a root's host event lost
        assert read(_ctx(kind, traced[kind], records=False)) is None            # no event record on the host
    monkeypatch.setattr(profiling, "spans", lambda: list(recs[other]))
    assert read(_ctx(kind, traced[other])) is None          # the other kind's roots
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(_ctx(kind, traced[kind])) is None           # no records
    monkeypatch.delattr(profiling, "spans")
    assert read(_ctx(kind, traced[kind])) is None           # a program without spans


@pytest.mark.parametrize("start, end, busy", [
    (-5.0, 0.0, 0.0),
    (0.0, 10.0, 10.0),
    (9.0, 13.0, 2.0),      # a part of two operations
    (10.0, 40.0, 23.0),    # overlapping operations counted once
    (38.0, 100.0, 47.0),
])
def test_busy_inside_an_interval(start, end, busy):
    from portbench.metrics._spans import covered_us, merged
    from portbench.trace import Event

    kernels = [Event("k", 0.0, 10.0), Event("k", 12.0, 20.0), Event("k", 15.0, 25.0), Event("k", 30.0, 40.0),
               Event("k", 32.0, 33.0), Event("k", 45.0, 90.0)]
    assert merged(kernels) == [(0.0, 10.0), (12.0, 25.0), (30.0, 40.0), (45.0, 90.0)]
    assert covered_us(merged(kernels), start, end) == pytest.approx(busy)


def test_anchor_passes_over_a_root_opened_on_a_busy_device():
    """Roots 1 ms apart whose entry events the host records at 1-2, 1001-1002,
    ... us; the device reaches root 2's 0.3 ms after its record: the anchor
    is where the first root's event lies all the same."""
    from portbench.metrics._spans import anchor_us
    from portbench.trace import Event

    roots = [_record("slam.step", None) for _ in range(5)]
    for i, r in enumerate(roots):
        r.start = _Event(i + (0.3 if i == 2 else 0.0))
    host = [Event("slam.step", 1000.0 * i, 1000.0 * i + 900.0) for i in range(5)]
    host += [Event("cudaEventRecordWithFlags", 1000.0 * i + t, 1000.0 * i + t + 1.0) for i in range(5) for t in (1, 500)]
    assert anchor_us(host, roots, roots[0].start) == pytest.approx(2.0)
    assert anchor_us(host[1:], roots, roots[0].start) is None  # a root's host event lost


# ------------------------------------------------------------------ on the card

def test_card_spans_leave_the_device_timeline_alone():
    """A fleet step of 8 robots at the preset's size, traced on the card: no
    device event carries a span's name, every stage has device time, and
    the top-level stages cover slam.step's interval within 5 %."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    cfg = tc.FLEET_CONFIG
    scans = _scans(n_scans=MAINTAIN_TICK + 3, robots=8).to(dev)
    step = fleet.make_fleet_step(cfg)
    states = fleet.fleet_init(scans[:, 0], cfg)
    for t in range(MAINTAIN_TICK):
        states, _, _ = step(states, scans[:, t + 1], t)
    torch.cuda.synchronize(dev)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        states, outs, _ = step(states, scans[:, MAINTAIN_TICK + 1], MAINTAIN_TICK)
        torch.cuda.synchronize(dev)
    recs = profiling.spans()
    names = {r.name for r in recs}
    assert names == {"slam.step", *STAGES, *UPDATE, "slam.maintain"}
    device = [e.name() for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert device and not [n for n in device if n in names or n.startswith(("slam.", "detect."))]
    ms = {r.name: r.device_ms() for r in recs}
    assert all(v is not None and v > 0 for v in ms.values()), ms
    top = sum(ms[s] for s in STAGES)
    assert abs(top - ms["slam.step"]) <= 0.05 * ms["slam.step"], ms
    assert sum(ms[s] for s in UPDATE + ("slam.maintain",)) <= ms["slam.update"] * (1 + 1e-6)
