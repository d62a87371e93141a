"""The v8 YOLO model of the port against the JAX package's, at 64 px, with
weights made from a numpy seed and carried across by `convert`.

Tolerance for head outputs: float32, 5e-4 absolute and relative.  The two
frameworks sum each of the ~25 stacked convs in another order, and the
unfolded BatchNorm divides where flax multiplies by a reciprocal square
root; the largest difference seen at these seeds is 5e-5 on outputs of
magnitude up to 23."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_slam_yolo_tpu.models import yolo as jyolo
from icp_slam_yolo_tpu_torch.convert import detector_params_from_numpy
from icp_slam_yolo_tpu_torch.models import yolo as tyolo
from icp_slam_yolo_tpu_torch.ops import pallas

torch.set_num_threads(2)
SIZE = 64
TOL = 5e-4
TASKS = ["detect", "obb", "segment", "pose"]


def seeded_tree(task: str, seed: int, num_classes: int = 2, variant: str = "n"):
    """The flax trees of an unfolded model with every leaf drawn from a numpy
    seed (non-trivial BatchNorm affines and statistics, so folding is tested)."""
    model = jyolo.YOLO(num_classes=num_classes, task=task, variant=variant)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            return (rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:3]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)  # bias, mean

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return tree["params"], tree["batch_stats"]


def _images(seed, bsz=2):
    return np.random.default_rng(seed).random((bsz, SIZE, SIZE, 3)).astype(np.float32)


def _flatten_outs(outs):
    if isinstance(outs, tuple):  # segment: (head outputs, protos)
        return [t for level in outs[0] for t in level] + [outs[1]]
    return [t for level in outs for t in level]


def _assert_outs_close(got, want, tol=TOL):
    got, want = _flatten_outs(got), _flatten_outs(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=tol, atol=tol)


def _port_model(params, stats, task, fold_bn, fused, num_classes=2, variant="n", dtype=torch.float32):
    model = tyolo.YOLO(num_classes=num_classes, task=task, variant=variant, fold_bn=fold_bn, fused=fused,
                       compute_dtype=dtype)
    model.load_state_dict(detector_params_from_numpy(params, stats, model))
    return model


@pytest.mark.parametrize("task", TASKS)
def test_unfolded_model_matches_jax(task):
    params, stats = seeded_tree(task, 11)
    x = _images(1)
    want = jyolo.YOLO(num_classes=2, task=task).apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = _port_model(params, stats, task, False, False)(torch.from_numpy(x))
    _assert_outs_close(got, want)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("task", TASKS)
def test_folded_model_matches_jax(task, fused):
    """Folded weights; the fused path runs the kernels' plain versions here
    (K5-K8 through their wrappers on CPU tensors)."""
    params, stats = seeded_tree(task, 12)
    x = _images(2)
    jp, js = jyolo.fold_batchnorm(params, stats)
    want = jyolo.YOLO(num_classes=2, task=task, fold_bn=True).apply({"params": jp, "batch_stats": js}, jnp.asarray(x))
    tp, ts = tyolo.fold_batchnorm(params, stats)
    before = dict(pallas.LAUNCHES)
    with torch.no_grad():
        got = _port_model(tp, ts, task, True, fused)(torch.from_numpy(x))
    _assert_outs_close(got, want)
    assert pallas.LAUNCHES == before, "a CPU forward must not count kernel launches"


def test_fold_batchnorm_equals_jax_leaf_for_leaf():
    params, stats = seeded_tree("segment", 13)
    jp, js = jyolo.fold_batchnorm(params, stats)
    tp, ts = tyolo.fold_batchnorm(params, stats)
    assert ts == {} and js == {}
    jl, tl = jax.tree_util.tree_leaves_with_path(jp), jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6, atol=1e-7)


def test_fused_equals_unfused_in_float32():
    """ROADMAP fault d: the two conv paths of the port compute one function.
    float32, 1e-4: the plain versions widen and sum as `F.conv2d` does."""
    params, stats = tyolo.fold_batchnorm(*seeded_tree("pose", 14))
    x = torch.from_numpy(_images(3))
    with torch.no_grad():
        a = _port_model(params, stats, "pose", True, True)(x)
        b = _port_model(params, stats, "pose", True, False)(x)
    for g, w in zip(_flatten_outs(a), _flatten_outs(b)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-4)


def test_bf16_fused_forward_close_to_float32():
    """bfloat16 compute on the fused path: finite, and within bfloat16
    accuracy of the float32 forward (0.15 absolute on logits of magnitude
    1-10 after ~25 layers of 3-significant-digit rounding)."""
    params, stats = tyolo.fold_batchnorm(*seeded_tree("detect", 15))
    x = torch.from_numpy(_images(4))
    with torch.no_grad():
        lo = _port_model(params, stats, "detect", True, True, dtype=torch.bfloat16)(x)
        hi = _port_model(params, stats, "detect", True, True)(x)
    for g, w in zip(_flatten_outs(lo), _flatten_outs(hi)):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g.float()).all())
        assert float((g.float() - w).abs().max()) < 0.15 * max(1.0, float(w.abs().max()) / 4)


@pytest.mark.parametrize("variant,ch", [("s", [32, 64, 128, 256, 512]), ("m", [48, 96, 192, 384, 768])])
def test_variants_s_and_m_match_jax(variant, ch):
    params, stats = seeded_tree("detect", 16, variant=variant)
    x = _images(5, bsz=1)
    want = jyolo.YOLO(num_classes=2, variant=variant).apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    model = _port_model(params, stats, "detect", False, False, variant=variant)
    assert model.ch == ch
    with torch.no_grad():
        _assert_outs_close(model(torch.from_numpy(x)), want)


def test_which_sites_take_which_kernel():
    """yolo-n: 7 stride-2 ConvBnActs (K7), 6 single-bottleneck C2f blocks
    (K8), and outside those blocks 12 1x1 sites (K5: 6 ConvBnActs, 6 head
    outputs) and 20 3x3 stride-1 sites (K6)."""
    model = tyolo.YOLO(fold_bn=True, fused=True)
    whole = [n for n, m in model.named_modules() if isinstance(m, tyolo.C2f) and m.whole_block_kernel()]
    assert sorted(whole) == ["c2f_2", "c2f_5", "neck_p3", "neck_p4", "pan_p4", "pan_p5"]
    outside = [(n, m) for n, m in model.named_modules() if not any(n.startswith(w + ".") for w in whole)]
    cba = [m for _, m in outside if isinstance(m, tyolo.ConvBnAct)]
    count = lambda k, s: sum((m.kernel, m.stride) == (k, s) for m in cba)  # noqa: E731
    assert count(3, 2) == 7 and count(3, 1) == 20
    assert count(1, 1) + sum(isinstance(m, tyolo.Conv1x1) for _, m in outside) == 12
    shortcuts = {n: model.get_submodule(n).Bottleneck_0.shortcut for n in whole}
    assert shortcuts == {n: n.startswith("c2f") for n in whole}


def test_unported_families_and_bad_options_raise():
    """An unknown family, and the kernels without folded weights, raise (v11
    and v12 are ported: `test_torch_yolo_families.py`)."""
    with pytest.raises(ValueError):
        tyolo.YOLO(family="v9")
    with pytest.raises(ValueError, match="fold_bn"):
        tyolo.YOLO(fused=True)


def test_convert_fails_loudly():
    params, stats = seeded_tree("detect", 17)
    model = tyolo.YOLO(num_classes=2)
    extra = dict(params, stray={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="not consumed"):
        detector_params_from_numpy(extra, stats, model)
    short = {k: v for k, v in params.items() if k != "stem"}
    with pytest.raises(KeyError, match="stem"):
        detector_params_from_numpy(short, stats, model)
    with pytest.raises(ValueError, match="the model has"):
        detector_params_from_numpy(params, stats, tyolo.YOLO(num_classes=3))
    with pytest.raises(KeyError, match="Conv_0/bias"):  # an unfolded tree into a folded model
        detector_params_from_numpy(params, stats, tyolo.YOLO(num_classes=2, fold_bn=True))


def test_reloading_weights_drops_cached_casts():
    params, stats = tyolo.fold_batchnorm(*seeded_tree("detect", 18))
    model = _port_model(params, stats, "detect", True, True)
    x = torch.from_numpy(_images(6, bsz=1))
    with torch.no_grad():
        first = _flatten_outs(model(x))
        other, _ = tyolo.fold_batchnorm(*seeded_tree("detect", 19))
        model.load_state_dict(detector_params_from_numpy(other, {}, model))
        second = _flatten_outs(model(x))
    assert not torch.allclose(first[0], second[0])
