"""The YOLO12-L cell's check driven through the rest of a run on the CPU at
128 px (the look for a card skipped): the program as it is comes out
correct; the float8 control, and a program whose stride-16 attention runs
over the whole map, come out not correct, both on ``b4_gap`` among others.  Then a ``--trace 1`` run with the
profiler's window faked reads the cell's trace metrics."""

import copy

import pytest
import torch

from portbench import run as harness
from portbench.spec import entry_module, load_cell

SEED = 2**31 + 77
CELL = "detect-yolo12l-b32"


def small():
    cell = load_cell(CELL)
    traffic, check, config = dict(cell.traffic), dict(cell.check), copy.deepcopy(cell.config)
    traffic.update(batch=4, pool=2, warm_calls=1)
    check.update(within=3)
    config.update(img_size=128)
    return cell._replace(traffic=traffic, check=check, config=config)


def test_sound_program_is_correct():
    line, _ = harness.run(small(), SEED, 0.0, False, torch.device("cpu"), [], [])
    assert line["correct"], line["checks"]


def test_float8_control_is_not_correct():
    cell = small()
    session = entry_module(cell).setup(cell, SEED, torch.device("cpu"))
    for i in range(4):
        session.before(i)
        session.call(i)
        session.after(i)
    session.release()
    checks = session.judge(control=True)
    assert not all(c.ok for c in checks), checks
    assert not {c.name: c for c in checks}["b4_gap"].ok, checks


def test_global_stride16_attention_is_not_correct(monkeypatch):
    from icp_slam_yolo_tpu_torch.models import yolo

    real = yolo.AAttn.forward

    def global_attention(self, x):
        area, self.area = self.area, 1
        try:
            return real(self, x)
        finally:
            self.area = area

    monkeypatch.setattr(yolo.AAttn, "forward", global_attention)
    line, _ = harness.run(small(), SEED, 0.0, False, torch.device("cpu"), [], [])
    assert not line["correct"], line["checks"]
    b4 = line["checks"]["b4_gap"]
    assert b4["value"] > b4["limit"], line["checks"]


def test_traced_run_reads_the_work_metrics(monkeypatch):
    """The entry's work count and the readers that take it: the convs' and
    the attention's roofline shares, the whole step's share of the peak and
    the idle share (the span readers read nothing without a profiler)."""
    from portbench import trace

    def fake(fn, device):
        fn()
        kernels = [trace.Event("void conv_bf16_kernel<1>", 0.0, 400.0),
                   trace.Event("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>", 400.0, 500.0)]
        return trace.Trace(kernels, [], 1000.0, 500.0)

    monkeypatch.setattr(trace, "traced", fake)
    e2e, per_layer, _ = harness.cell_metrics(CELL)
    line, _ = harness.run(small(), SEED, 0.0, True, torch.device("cpu"), e2e, per_layer)
    got = line["metrics"]
    assert {"detect_mfu", "conv_roofline_share", "attn_roofline_share", "idle_share.detect"} <= set(got)
    assert got["idle_share.detect"]["value"] == pytest.approx(50.0)
    assert 0 < got["attn_roofline_share"]["value"] and 0 < got["conv_roofline_share"]["value"]


def test_frames_the_reference_does_not_resolve_are_left_out():
    """`_resolved` keeps a frame whose reference outputs move with a 1e-6
    perturbation of it as a smooth function does, and leaves out one whose
    outputs swing (a float32 reference that rounding alone decides)."""
    from portbench.entries import detect_yolo12 as E

    class Swinging:
        kept = {}

        def forward(self, images, keep=()):
            self.kept = {k: images for k in keep}
            out = images.clone()
            out[1] = torch.sin(images[1] * 1e9)
            return [(out, out)]

    session = E.Yolo12Session.__new__(E.Yolo12Session)
    session.seed = SEED
    images = torch.rand(3, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    model = Swinging()
    levels, _ = session._levels(model, images)
    assert session._resolved(model, images, levels, 0).tolist() == [True, False, True]
