"""The published YOLO12 in the port (``YOLO(family="yolo12")``, `ops/attention.py`,
`io/torch_import.py`'s yolo12 mapping) against the plain reference
(`reference_impl/yolo12.py`), on seeded Ultralytics-layout weights, float32, on
the CPU.

Tolerances:
* head outputs, port against reference: 1e-3 of the largest |logit|.  The
  BatchNorms are calibrated on an 8-frame batch, so at 64-128 px the deepest
  maps (2 x 2 to 4 x 4) normalise 32-128 values a channel and amplify float32
  rounding: the gaps read 1e-5 (n, 128 px) to 1e-4 (l, 64 px), and a band
  split made global or q and k swapped read 4e-2 and more;
* the attention core against the plain product: 1e-6 of the largest output
  (the same float32 products, batched one way or another);
* counts, the layout and the mapping: exact.
"""

import functools

import pytest
import torch

from icp_slam_yolo_tpu_torch.io import torch_import as ti
from icp_slam_yolo_tpu_torch.models import detect as tdetect
from icp_slam_yolo_tpu_torch.models import yolo as Y
from icp_slam_yolo_tpu_torch.ops import attention as A
from icp_slam_yolo_tpu_torch.ops.nms import suppress
from icp_slam_yolo_tpu_torch.reference_impl import yolo12 as R
from icp_slam_yolo_tpu_torch.utils import profiling

torch.set_num_threads(2)

VARIANTS = "nsmlx"
# Ultralytics' table: parameters (80 classes) unfolded and folded, and the
# convs' GFLOP at 640 px
PARAMS = {"n": (2602288, 2590824), "s": (9284096, 9261840), "m": (20199168, 20166592),
          "l": (26450784, 26400752), "x": (59210784, 59135744)}
GFLOP_640 = {"n": 6.5, "s": 21.4, "m": 67.5, "l": 88.9, "x": 199.0}
SIZES = {"n": 128, "l": 64}  # the comparisons' input sides
TOL = 1e-3


def cfg(variant: str, num_classes: int = 1) -> dict:
    return {"variant": variant, "num_classes": num_classes, "reg_max": 16, "bn_eps": 1e-3}


@functools.lru_cache(maxsize=None)
def seeded(variant: str, seed: int = 0):
    """An Ultralytics-layout state (BatchNorm statistics calibrated on 8
    frames) and 2 frames to compare on, NCHW."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in R.state_layout(variant, 1):
        z = torch.randn(shape, generator=g)
        if key.endswith("dfl.conv.weight"):
            sd[key] = torch.arange(16.0).view(shape)
        elif len(shape) == 4:
            sd[key] = (z - z.mean((1, 2, 3), keepdim=True)) / (shape[1] * shape[2] * shape[3]) ** 0.5
        elif key.endswith(("bn.weight", "running_var")):
            sd[key] = 0.5 + torch.rand(shape, generator=g)
        elif key.endswith("gamma"):
            sd[key] = torch.full(shape, 0.01)
        else:
            sd[key] = 0.1 * z
    size = SIZES[variant]
    frames = torch.rand(8, 3, size, size, generator=g)
    sd = R.calibrate(cfg(variant), sd, frames)
    return sd, frames[:2]


@functools.lru_cache(maxsize=None)
def reference_levels(variant: str):
    sd, x = seeded(variant)
    with torch.no_grad():
        return R.Model(cfg(variant), sd).forward(x)


def port(variant: str, fold: bool, fused: bool) -> Y.YOLO:
    sd, _ = seeded(variant)
    state = ti.validate_against_model(ti.convert_state_dict(sd, "yolo12"),
                                      Y.YOLO(num_classes=1, variant=variant, family="yolo12"))
    model = Y.YOLO(num_classes=1, variant=variant, family="yolo12", fold_bn=fold, fused=fused)
    model.load_state_dict(ti.fold_state_dict(state, Y.BN_EPS) if fold else state)
    return model


def gap(model: Y.YOLO, variant: str) -> float:
    """The head outputs' largest gap to the reference's, over the largest |logit|."""
    _, x = seeded(variant)
    ref = reference_levels(variant)
    with torch.no_grad():
        got = model(x.permute(0, 2, 3, 1))
    scale = max(float(r.abs().max()) for level in ref for r in level)
    worst = 0.0
    for g_level, r_level in zip(got, ref):
        for g, r in zip(g_level, r_level):
            assert tuple(g.permute(0, 3, 1, 2).shape) == tuple(r.shape)
            worst = max(worst, float((g.permute(0, 3, 1, 2) - r).abs().max()))
    return worst / scale


# ------------------------------------------------------------------ shapes and counts

@pytest.mark.parametrize("variant", VARIANTS)
def test_parameter_counts(variant):
    """Ultralytics' counts (80 classes, DFL's 16 included) from the
    reference's layout alone, and from the port's trees built on the meta
    device (no weights made), unfolded and folded."""
    layout = R.state_layout(variant, 80)
    numel = {k: torch.Size(s).numel() for k, s in layout}
    unfolded = sum(n for k, n in numel.items() if not k.endswith(("running_mean", "running_var")))
    bn_channels = sum(n for k, n in numel.items() if k.endswith("bn.weight"))
    assert (unfolded, unfolded - bn_channels) == PARAMS[variant]
    with torch.device("meta"):
        trees = [Y.YOLO(num_classes=80, variant=variant, family="yolo12", fold_bn=f) for f in (False, True)]
    assert tuple(sum(p.numel() for p in t.parameters()) + 16 for t in trees) == PARAMS[variant]


@pytest.mark.parametrize("variant", VARIANTS)
def test_conv_gflop_at_640(variant):
    """The benchmark reference's conv operations (80 classes, 640 px, 2 a
    multiply-add) within 0.1 GFLOP of Ultralytics' published figure."""
    from portbench.reference import yolo12 as P

    assert abs(P.conv_flops(cfg(variant, 80), 640) / 1e9 - GFLOP_640[variant]) <= 0.1


def test_cell_counts():
    """At the cell's shapes (l, 1 class, 1024 px, batch 32): 269.6 GFLOP an
    image, 29 % of them in the 16 ABlocks, and 10,737,418,240 scores a batch."""
    from portbench.reference import yolo12 as P

    c = cfg("l")
    sites, attn = P.site_work(c, 1024), P.attention_work(c, 1024)
    total = sum(s["ops"] for s in sites) + sum(a["ops"] for a in attn)
    blocks = sum(s["ops"] for s in sites if ".attn." in s["site"] or ".mlp." in s["site"]) + sum(a["ops"] for a in attn)
    assert round(total / 1e9, 1) == 269.6 and round(100 * blocks / total) == 29 and len(attn) == 16
    scores = 8 * A.scores(32, 64, 64, 8, 4) + 8 * A.scores(32, 32, 32, 8, 1)
    assert scores == 32 * sum(a["scores"] for a in attn) == 10_737_418_240


def test_smoke_sites_are_the_cells_kernel_sites():
    """`chip_smoke.YOLO12L_SITES`, which the card's smoke run holds K5-K7 to,
    are exactly the kernel sites of the cell's forward (l, 1 class, 1024 px)
    with their counts, by kernel."""
    import chip_smoke
    from portbench.reference import yolo12 as P

    acts = {site[0]: site[6] for site in P.conv_sites("l", 1)}
    names = {(1, 1): "conv1x1_silu", (3, 1): "conv3x3_silu", (3, 2): "conv3x3s2_silu"}
    want = {name: {} for name in names.values()}
    for s in P.site_work(cfg("l"), 1024):
        if s["kernel"]:
            key = (s["cin"], s["cout"], s["hw_in"], acts[s["site"]])
            by = want[names[(s["k"], s["hw_in"] // s["hw_out"])]]
            by[key] = by.get(key, 0) + 1
    got = {name: {site[:4]: site[4] for site in sites} for name, sites in chip_smoke.YOLO12L_SITES.items()}
    assert got == want
    assert sum(len(v) for v in chip_smoke.YOLO12L_SITES.values()) == sum(len(v) for v in got.values())


def test_dense_sites_take_the_kernels_and_grouped_ones_do_not():
    """YOLO12-L folded and fused: every dense 1x1 and 3x3 site is K5-K7's,
    every grouped one (the 16 ``pe`` 7x7s, the head's 6 depthwise 3x3s) a
    library call, as the benchmark reference counts them."""
    from portbench.reference import yolo12 as P

    with torch.device("meta"):
        model = Y.YOLO(num_classes=1, variant="l", family="yolo12", fold_bn=True, fused=True)
    cbas = [m for m in model.modules() if isinstance(m, Y.ConvBnAct)]
    outs = [m for m in model.modules() if isinstance(m, Y.Conv1x1)]
    grouped = [m for m in cbas if m.groups > 1]
    assert len(grouped) == 22 and not any(m.uses_kernels() for m in grouped)
    assert all(m.uses_kernels() for m in cbas if m.groups == 1) and all(m.fused for m in outs)
    assert len(cbas) - len(grouped) + len(outs) == sum(s["kernel"] for s in P.site_work(cfg("l"), 1024))


# ------------------------------------------------------------------ against the reference

@pytest.mark.parametrize("mode", ["unfolded", "folded", "fused"])
@pytest.mark.parametrize("variant", ["n", "l"])
def test_head_outputs_match_the_reference(variant, mode):
    model = port(variant, mode != "unfolded", mode == "fused")
    assert gap(model, variant) <= TOL


@pytest.mark.parametrize("mutation", ["stride16_global", "qk_swapped"])
def test_mutations_fail_the_reference_comparison(mutation, monkeypatch):
    """The stride-16 attention run over the whole map, or the head-grouped q
    and k channels swapped: the port-vs-reference comparison fails."""
    model = port("l", True, True)
    if mutation == "stride16_global":
        for m in model.b4.modules():
            if isinstance(m, Y.AAttn):
                m.area = 1
    else:
        real = A.band_views
        monkeypatch.setattr(A, "band_views", lambda *a: (lambda q, k, v: (k, q, v))(*real(*a)))
    assert gap(model, "l") > 10 * TOL


def _published_core(qkv: torch.Tensor, heads: int, area: int) -> torch.Tensor:
    """Ultralytics' ``AAttn.forward`` between ``qkv`` and ``pe``, on NHWC."""
    b, h, w, c3 = qkv.shape
    c, n, hd = c3 // 3, h * w, c3 // 3 // heads
    x = qkv.reshape(b, n, c3)
    if area > 1:
        x = x.reshape(b * area, n // area, c3)
    bb, nn_ = x.shape[:2]
    q, k, v = x.view(bb, nn_, heads, 3 * hd).permute(0, 2, 3, 1).split([hd, hd, hd], dim=2)
    attn = ((q.transpose(-2, -1) @ k) * hd ** -0.5).softmax(dim=-1)
    y = (v @ attn.transpose(-2, -1)).permute(0, 3, 1, 2)
    return y.reshape(b, n, c).reshape(b, h, w, c)


@pytest.mark.parametrize("area", [1, 4])
def test_attention_core_matches_the_plain_product(area):
    qkv = torch.randn(2, 8, 6, 3 * 64, generator=torch.Generator().manual_seed(area))
    got, want = A.area_attention(qkv, 2, area), _published_core(qkv, 2, area)
    assert got.shape == want.shape == (2, 8, 6, 64)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_attention_refuses_an_area_count_that_does_not_divide_the_map():
    qkv = torch.randn(1, 5, 5, 96)
    with pytest.raises(ValueError, match="does not split into 4 areas"):
        A.area_attention(qkv, 1, 4)
    with pytest.raises(ValueError, match="does not split into 4 areas"):
        R.Model(cfg("n"), seeded("n")[0]).aattn(torch.randn(1, 64, 5, 5), "model.6.m.0.0.attn", 4)


def test_scores_counted_in_the_attention_spans():
    """Under a profiler each AAttn core is one ``detect.attention`` span
    whose ``scores`` are ``B area heads T^2``."""
    from portbench.reference import yolo12 as P
    from torch.profiler import ProfilerActivity, profile

    model = port("n", True, True)
    _, x = seeded("n")
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        model(x.permute(0, 2, 3, 1))
        recs = [r for r in profiling.spans() if r.name == "detect.attention"]
    profiling.clear_spans()
    work = P.attention_work(cfg("n"), SIZES["n"])
    assert len(recs) == len(work) == 8 and all(r.own_start for r in recs)
    assert [r.counts["scores"] for r in recs] == [2 * a["scores"] for a in work]


def test_benchmark_reference_is_the_same_bits():
    """`portbench/reference/yolo12.py` is a copy of the program's reference:
    the same layout and, on one state, the same head outputs bit for bit."""
    from portbench.reference import yolo12 as P

    for v in VARIANTS:
        assert P.state_layout(v, 3) == R.state_layout(v, 3) and P.architecture(v) == R.architecture(v)
    sd, x = seeded("n")
    with torch.no_grad():
        a, b = R.Model(cfg("n"), sd).forward(x), P.Model(cfg("n"), sd).forward(x)
    assert all(torch.equal(p, q) for la, lb in zip(a, b) for p, q in zip(la, lb))


# ------------------------------------------------------------------ the import and the detector

@pytest.mark.parametrize("variant", VARIANTS)
def test_convert_maps_the_layout_one_to_one(variant):
    """Every key of the reference's layout but the DFL's lands on exactly one
    port key of the same shape, and the port's tree has no other; the scale
    is read back from the shapes."""
    layout = dict(R.state_layout(variant, 1))
    ids = {k: torch.tensor(float(i)) for i, k in enumerate(layout)}
    got = ti.convert_state_dict(dict(ids), "yolo12")
    keys = list(layout)
    source = {k: keys[int(v)] for k, v in got.items()}
    assert sorted(source.values()) == sorted(k for k in keys if ".dfl." not in k)
    with torch.device("meta"):
        own = Y.YOLO(num_classes=1, variant=variant, family="yolo12").state_dict()
    own = {k: tuple(v.shape) for k, v in own.items() if not k.endswith("num_batches_tracked")}
    assert set(own) == set(got)
    assert all(own[k] == tuple(layout[s]) for k, s in source.items())
    shaped = {k: torch.empty(0).new_empty(own[k], device="meta") for k in own}
    assert ti.yolo12_scale(shaped) == (variant, 1)


def test_v12_is_refused_and_pointed_at_yolo12():
    with pytest.raises(ValueError, match="only family='v8' and family='yolo12'"):
        ti.convert_state_dict({}, family="v12")


@pytest.mark.parametrize("variant", VARIANTS + "8")
def test_pt_family_is_read_from_the_keys(variant):
    """A yolo12 layout (every scale) reads as ``yolo12``; v8's head, whose
    ``cv3.<i>.0`` is a plain conv, and its C2f bottlenecks read as ``v8``."""
    if variant == "8":
        keys = ["model.2.m.0.cv1.conv.weight", "model.22.cv3.0.0.conv.weight", "model.22.cv3.0.2.weight"]
        assert ti.ultralytics_family(dict.fromkeys(keys)) == "v8"
    else:
        assert ti.ultralytics_family(dict(R.state_layout(variant, 1))) == "yolo12"


def test_detector_serves_yolo12_from_a_pt_file(tmp_path):
    """A plain yolo12 state dict saved with ``torch.save`` loads through
    `detector_from_checkpoint` (family, scale and classes read from the
    weights) and `predict_batch` gives the decode and suppression of
    the reference's head outputs."""
    sd, x = seeded("n")
    path = str(tmp_path / "yolo12n.pt")
    torch.save(sd, path)
    det = tdetect.detector_from_checkpoint(path, conf_threshold=1e-3, compute_dtype=torch.float32,
                                           img_size=SIZES["n"], pallas_convs=True, device="cpu")
    assert (det.model.family, det.model.variant, det.model.num_classes, det.model.fused) == ("yolo12", "n", 1, True)
    got = det.predict_batch(x.permute(0, 2, 3, 1))
    ref = [tuple(t.permute(0, 2, 3, 1) for t in level) for level in reference_levels("n")]
    boxes, scores, classes, idx, _ = Y.decode_topk(ref, SIZES["n"], det.max_detections)
    want = suppress(boxes, scores, classes, idx, scores >= 1e-3, det.iou_threshold)
    assert int(want.valid.sum()) > 0
    assert torch.equal(got.valid, want.valid) and torch.equal(got.anchor_idx, want.anchor_idx)
    assert float((got.boxes - want.boxes).abs().max()) <= 1e-2 and float((got.scores - want.scores).abs().max()) <= 1e-4


# ------------------------------------------------------------------ on the card

def test_card_attention_is_fused_and_agrees_with_the_plain_product():
    """At the cell's stride-16 shape (batch 4), bf16: SDPA's fused kernels
    run, no softmax kernel does, and the output is within bf16 rounding of
    the float32 product of the same bf16 inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    qkv = torch.randn(4, 64, 64, 768, device="cuda", dtype=torch.bfloat16)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = A.area_attention(qkv, 8, 4)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.self_device_time_total > 0]
    assert names and not any("softmax" in n.lower() for n in names), names
    want = A.area_attention(qkv.float().cpu(), 8, 4)
    assert float((got.float().cpu() - want).abs().max()) <= 2 ** -7 * float(want.abs().max())
