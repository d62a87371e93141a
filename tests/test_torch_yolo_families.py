"""The v11 and v12 YOLO families of the port against the JAX package's, at
64 px, with weights made from a numpy seed and carried across by `convert`:
the blocks alone (C3k, C3k2, Attention2d, PSABlock, C2PSA, ABlock, A2C2f),
the whole model at every task, unfolded, folded and folded on the fused
path (the kernels' plain versions on the CPU), `fold_batchnorm`, which conv
site takes which kernel, and `convert`'s refusals.

Tolerances, float32.  v11 and the blocks without attention: 5e-4 absolute
and relative, as for v8 (`test_torch_yolo.py`); the largest difference
seen at these seeds is 4e-6 on outputs of magnitude up to 3.  v12 and the
blocks with attention: 1e-3 of each output's largest magnitude.  The
seeded weights give logits in the hundreds, and the softmax turns float32
rounding of the logits into differences of ~1e-4 of the output's scale:
against a float64 forward of the port, the port's and the JAX package's
float32 outputs differ by the same order (v12-m detect, outputs up to 47:
0.016 and 0.005; v12-n obb, up to 873: 0.004 and 0.004), and from each
other by at most 4.3e-4 of the scale.  The seeded trees keep the bare
BatchNorms of the attention blocks at a fifth of the scale and ``gamma``
near 0.1 (a trained model's residual branches are small: flax initialises
``gamma`` at 0.01); at full scale eight stacked residual attention blocks
reach activations of 1e5."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_slam_yolo_tpu_torch as port
from icp_slam_yolo_tpu.models import yolo as jyolo
from icp_slam_yolo_tpu.ops.pallas import conv_fused as jconv
from icp_slam_yolo_tpu_torch.convert import detector_params_from_numpy
from icp_slam_yolo_tpu_torch.models import yolo as tyolo
from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.pallas import c2f_fused as tc2f
from icp_slam_yolo_tpu_torch.ops.pallas import conv_fused as tconv
from test_torch_yolo import _assert_outs_close, _flatten_outs, _images

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
TASKS = ["detect", "obb", "segment", "pose"]
FAMILIES = ["v11", "v12"]


def _fill(rng):
    def fill(path, leaf):
        keys = [getattr(k, "key", "") for k in path]
        name, shape = keys[-1], leaf.shape
        bare_bn = len(keys) >= 3 and keys[-2] == "BatchNorm_0" and keys[-3].startswith(("PSABlock", "ABlock"))
        if name == "kernel":
            return (rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:3]))).astype(np.float32)
        if name == "scale":
            return ((0.2 if bare_bn else 1.0) * (1.0 + 0.2 * rng.standard_normal(shape))).astype(np.float32)
        if name == "gamma":
            return (0.1 + 0.02 * rng.standard_normal(shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)  # bias, mean
    return fill


def seeded_tree(family: str, task: str, seed: int, num_classes: int = 2, variant: str = "n"):
    """The flax trees of an unfolded ``family`` model, every leaf drawn from
    a numpy seed."""
    model = jyolo.YOLO(num_classes=num_classes, task=task, variant=variant, family=family)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))
    tree = jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(seed)), shapes)
    return tree["params"], tree["batch_stats"]


def _assert_close(got, want, attention: bool):
    """The file's tolerances (module docstring): elementwise for the
    families and blocks without attention, scaled by each output's largest
    magnitude with it."""
    if not attention:
        _assert_outs_close(got, want)
        return
    got, want = _flatten_outs(got), _flatten_outs(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g.float().numpy() - w).max()) <= 1e-3 * scale


def _port(params, stats, family, task, fold_bn, fused, variant="n", dtype=torch.float32):
    model = tyolo.YOLO(num_classes=2, task=task, family=family, variant=variant, fold_bn=fold_bn, fused=fused,
                       compute_dtype=dtype)
    model.load_state_dict(detector_params_from_numpy(params, stats, model))
    return model


# ---- the blocks alone

def _block_pair(name: str, seed: int):
    """A JAX block with seeded weights and the port's block with the same."""
    c = 32
    jmod, tmod = {
        "C3k": (jyolo.C3k(24, 2), tyolo.C3k(c, 24, 2)),
        "C3k2": (jyolo.C3k2(40, 1, False, 0.25), tyolo.C3k2(c, 40, 1, False, 0.25)),
        "C3k2-c3k": (jyolo.C3k2(32, 2, True), tyolo.C3k2(c, 32, 2, True)),
        "PSABlock": (jyolo.PSABlock(c), tyolo.PSABlock(c)),
        "C2PSA": (jyolo.C2PSA(c, 1), tyolo.C2PSA(c, c, 1)),
        "ABlock": (jyolo.ABlock(c, 4), tyolo.ABlock(c, 4)),
        "A2C2f": (jyolo.A2C2f(c, 2, True, 4), tyolo.A2C2f(c, c, 2, True, 4)),
        "A2C2f-c3k": (jyolo.A2C2f(48, 1, False), tyolo.A2C2f(c, 48, 1, False)),
    }[name]
    x = np.random.default_rng(seed).standard_normal((2, 12, 12, c)).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), jnp.asarray(x))
    tree = jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(seed)), shapes)
    tmod.load_state_dict(detector_params_from_numpy(tree["params"], tree.get("batch_stats", {}), tmod))
    return jmod, tmod, tree, x


@pytest.mark.parametrize("name", ["C3k", "C3k2", "C3k2-c3k", "PSABlock", "C2PSA", "ABlock", "A2C2f", "A2C2f-c3k"])
def test_block_matches_jax(name):
    """Each block alone on a 12 x 12 map of 32 channels (float32, 5e-4);
    the A2C2f with ``a2`` carries ``gamma``, the one without does not."""
    jmod, tmod, tree, x = _block_pair(name, 31)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    _assert_close([got], [want], attention=name in ("PSABlock", "C2PSA", "ABlock", "A2C2f"))
    if name.startswith("A2C2f"):
        assert (tmod.gamma is not None) == (name == "A2C2f") == ("gamma" in tree["params"])


@pytest.mark.parametrize("h,w,area,heads", [(12, 12, 4, 2), (10, 7, 4, 1), (8, 8, 1, 4), (6, 6, 3, 2)])
def test_attention_matches_jax(h, w, area, heads):
    """Attention2d: the areas are horizontal bands of the row-major map (4
    bands of 36 cells at 12 x 12), ``area`` falls back to 1 where it does not
    divide ``h * w`` (70 cells), ``kd = max(hd // 2, 8)``; float32, 5e-4."""
    c = 32
    jmod = jyolo.Attention2d(heads, area)
    tmod = tyolo.Attention2d(c, heads, area)
    x = np.random.default_rng(h * w).standard_normal((2, h, w, c)).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), jnp.asarray(x))
    tree = jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(7)), shapes)
    tmod.load_state_dict(detector_params_from_numpy(tree["params"], {}, tmod))
    assert tmod.kd == max(c // heads // 2, 8)
    assert tuple(tmod.Conv_3.conv.weight.shape) == (c, 1, 3, 3)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    _assert_close([got], [want], attention=True)


def test_attention_in_bfloat16_follows_the_jax_casts():
    """bfloat16 working type: the port's attention against the JAX one in
    bfloat16 (float32 logits and softmax, probabilities cast to bfloat16,
    the second product summed in float32), within bfloat16 accuracy (0.05
    on outputs of magnitude ~3)."""
    c = 32
    jmod = jyolo.Attention2d(2, 4, dtype=jnp.bfloat16)
    tmod = tyolo.Attention2d(c, 2, 4, dtype=torch.bfloat16)
    x = np.random.default_rng(5).standard_normal((1, 12, 12, c)).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), jnp.asarray(x))
    tree = jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(8)), shapes)
    tmod.load_state_dict(detector_params_from_numpy(tree["params"], {}, tmod))
    want = np.asarray(jmod.apply(tree, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05, rtol=0.02)


# ---- the whole model

@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("family", FAMILIES)
def test_unfolded_model_matches_jax(family, task):
    params, stats = seeded_tree(family, task, 41)
    x = _images(1)
    want = jyolo.YOLO(num_classes=2, task=task, family=family).apply({"params": params, "batch_stats": stats},
                                                                      jnp.asarray(x))
    with torch.no_grad():
        got = _port(params, stats, family, task, False, False)(torch.from_numpy(x))
    _assert_close(got, want, family == "v12")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("family", FAMILIES)
def test_folded_model_matches_jax(family, task, fused):
    """Folded weights (the bare BatchNorms stay); the fused path runs the
    kernels' plain versions here, and a CPU forward counts no launch."""
    params, stats = seeded_tree(family, task, 42)
    x = _images(2)
    jp, js = jyolo.fold_batchnorm(params, stats)
    want = jyolo.YOLO(num_classes=2, task=task, family=family, fold_bn=True).apply(
        {"params": jp, "batch_stats": js}, jnp.asarray(x))
    tp, ts = tyolo.fold_batchnorm(params, stats)
    before = dict(pallas.LAUNCHES)
    with torch.no_grad():
        got = _port(tp, ts, family, task, True, fused)(torch.from_numpy(x))
    _assert_close(got, want, family == "v12")
    assert pallas.LAUNCHES == before, "a CPU forward must not count kernel launches"


@pytest.mark.parametrize("family", FAMILIES)
def test_fold_batchnorm_equals_jax_leaf_for_leaf(family):
    """Only a ConvBnAct's BatchNorm folds: the bare ones of PSABlock/ABlock
    keep their parameters and statistics, in both packages."""
    params, stats = seeded_tree(family, "segment", 43)
    jp, js = jyolo.fold_batchnorm(params, stats)
    tp, ts = tyolo.fold_batchnorm(params, stats)
    for jt, tt in ((jp, tp), (js, ts)):
        jl, tl = jax.tree_util.tree_leaves_with_path(jt), jax.tree_util.tree_leaves_with_path(tt)
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (_, a), (_, b) in zip(jl, tl):
            np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6, atol=1e-7)
    bare = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(ts)]
    block = "PSABlock_0" if family == "v11" else "ABlock_0"
    assert bare and all(block[:-2] in k and "BatchNorm_0" in k for k in bare), bare


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_equals_unfused_in_float32(family):
    """The two conv paths of the port compute one function (float32, 1e-4:
    the plain versions widen and sum as `F.conv2d` does)."""
    params, stats = tyolo.fold_batchnorm(*seeded_tree(family, "pose", 44))
    x = torch.from_numpy(_images(3))
    with torch.no_grad():
        a = _port(params, stats, family, "pose", True, True)(x)
        b = _port(params, stats, family, "pose", True, False)(x)
    for g, w in zip(_flatten_outs(a), _flatten_outs(b)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["pallet_detect_v12_640", "pallet_obb_v11_640"])
def test_bf16_fused_forward_close_to_float32(name):
    """bfloat16 on the fused path, with the trained weights at a 64 px
    input: finite, and within bfloat16 accuracy of the float32 forward (the
    v8 rule, 0.15 absolute on logits of magnitude 1-10; seen: 0.21 of 19.7
    for v12, 0.05 of 15 for v11).  Seeded weights are no test of this:
    their attention logits run to the hundreds, where a bfloat16 softmax
    picks other keys."""
    path = os.path.join(REPO, "checkpoints", name + ".msgpack")
    x = torch.from_numpy(_images(4))
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        det = port.detector_from_checkpoint(path, compute_dtype=dt, pallas_convs=True, device="cpu", img_size=SIZE)
        with torch.no_grad():
            outs[dt] = _flatten_outs(det.model(x))
    for g, w in zip(outs[torch.bfloat16], outs[torch.float32]):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g.float()).all())
        assert float((g.float() - w).abs().max()) < 0.15 * max(1.0, float(w.abs().max()) / 4)


@pytest.mark.parametrize("variant,ch", [("s", [32, 64, 128, 256, 512]), ("m", [64, 128, 256, 512, 1024])])
@pytest.mark.parametrize("family", FAMILIES)
def test_variants_s_and_m_match_jax(family, variant, ch):
    """The s and m scales' widths, and their detect forward against JAX
    (batch 1); every task builds at each scale with JAX's parameter count."""
    params, stats = seeded_tree(family, "detect", 45, variant=variant)
    x = _images(5, bsz=1)
    want = jyolo.YOLO(num_classes=2, variant=variant, family=family).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    model = _port(params, stats, family, "detect", False, False, variant=variant)
    assert model.ch == ch
    with torch.no_grad():
        _assert_close(model(torch.from_numpy(x)), want, family == "v12")
    for task in TASKS:
        jm = jyolo.YOLO(num_classes=2, task=task, variant=variant, family=family)
        shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))
        n_jax = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(shapes["params"]))
        tm = tyolo.YOLO(num_classes=2, task=task, variant=variant, family=family)
        assert sum(p.numel() for p in tm.parameters()) == n_jax, task


# ---- which conv site takes which kernel

def _port_routing(model, x):
    """Calls of each kernel wrapper in one CPU forward of the port."""
    counts = dict.fromkeys(("conv1x1_silu", "conv3x3_silu", "conv3x3s2_silu", "c2f_fused"), 0)
    real = {name: getattr(tconv, name) for name in counts if name != "c2f_fused"}
    real["c2f_fused"] = tc2f.c2f_fused

    def counting(name):
        def call(*a, **k):
            counts[name] += 1
            return real[name](*a, **k)
        return call

    patch = pytest.MonkeyPatch()
    try:
        for name in counts:
            patch.setattr(tc2f if name == "c2f_fused" else tconv, name, counting(name))
        with torch.no_grad():
            model(x)
    finally:
        patch.undo()
    return counts


def _jax_routing(family, params, stats, x):
    """Calls of each Pallas conv function that the JAX package's
    `pallas_cba_interceptor` makes in one forward of the folded model (the
    functions replaced by zeros of the right shape: only the routing is
    counted)."""
    counts = dict.fromkeys(("conv1x1_silu", "conv3x3_silu", "conv3x3s2_silu"), 0)

    def zeros(name, stride):
        def call(x, w, b, **_):
            counts[name] += 1
            return jnp.zeros((x.shape[0], x.shape[1] // stride, x.shape[2] // stride, w.shape[-1]), x.dtype)
        return call

    patch = pytest.MonkeyPatch()
    try:
        patch.setattr(jconv, "conv1x1_silu", zeros("conv1x1_silu", 1))
        patch.setattr(jconv, "conv3x3_silu", zeros("conv3x3_silu", 1))
        patch.setattr(jconv, "conv3x3s2_silu", zeros("conv3x3s2_silu", 2))
        with fnn.intercept_methods(jconv.pallas_cba_interceptor):
            jyolo.YOLO(num_classes=2, family=family, fold_bn=True).apply(
                {"params": params, "batch_stats": stats}, jnp.asarray(x))
    finally:
        patch.undo()
    return counts


# launches of K5 / K6 / K7 / K8 in one yolo-n forward (detect)
SITES = {"v11": (41, 34, 7, 0), "v12": (82, 32, 7, 0)}


@pytest.mark.parametrize("family", FAMILIES)
def test_which_sites_take_which_kernel(family):
    """With ``fused=True`` every folded ConvBnAct goes to K5/K6/K7 by its
    (kernel, stride), every plain 1x1 conv (the heads' outputs, q, k, v and
    the projection, the 1x1 before a bare BatchNorm) to K5, the depthwise
    3x3 to no kernel, and no block to K8 (C3k2, C3k and A2C2f are not a C2f):
    the same calls of each kernel as the JAX package's interceptor makes at
    640 px (below it, the TPU's packing rules send some small maps to XLA;
    the port's kernels take every size)."""
    params, stats = tyolo.fold_batchnorm(*seeded_tree(family, "detect", 46))
    x = np.random.default_rng(6).random((1, 640, 640, 3)).astype(np.float32)
    got = _port_routing(_port(params, stats, family, "detect", True, True), torch.from_numpy(x))
    want = _jax_routing(family, params, stats, x)
    assert {k: got[k] for k in want} == want
    assert (got["conv1x1_silu"], got["conv3x3_silu"], got["conv3x3s2_silu"], got["c2f_fused"]) == SITES[family]
    model = tyolo.YOLO(family=family, fold_bn=True, fused=True)
    assert not any(isinstance(m, tyolo.C2f) for m in model.modules())
    n_dw = sum(isinstance(m, tyolo.DepthwiseConv3x3) for m in model.modules())
    assert n_dw == sum(isinstance(m, tyolo.Attention2d) for m in model.modules()) > 0


def test_unknown_family_and_bad_options_raise():
    with pytest.raises(ValueError, match="unknown family"):
        tyolo.YOLO(family="v10")
    with pytest.raises(ValueError, match="fold_bn"):
        tyolo.YOLO(family="v12", fused=True)


@pytest.mark.parametrize("family", FAMILIES)
def test_convert_fails_loudly(family):
    """A stray leaf, a missing bare BatchNorm statistic or ``gamma``, or an
    unfolded tree into a folded model: an error naming the leaf."""
    params, stats = seeded_tree(family, "detect", 47)
    model = tyolo.YOLO(num_classes=2, family=family)
    extra = dict(params, stray={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="not consumed"):
        detector_params_from_numpy(extra, stats, model)
    block = "psa" if family == "v11" else "b4"
    short = {k: v for k, v in stats.items() if k != block}
    with pytest.raises(KeyError, match=f"batch_stats/{block}/"):
        detector_params_from_numpy(params, short, model)
    if family == "v12":
        no_gamma = dict(params, b4={k: v for k, v in params["b4"].items() if k != "gamma"})
        with pytest.raises(KeyError, match="b4/gamma"):
            detector_params_from_numpy(no_gamma, stats, model)
    with pytest.raises(KeyError, match="Conv_0/bias"):
        detector_params_from_numpy(params, stats, tyolo.YOLO(num_classes=2, family=family, fold_bn=True))
