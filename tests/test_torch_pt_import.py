"""The port's Ultralytics ``.pt`` import (`io/torch_import.py`, the ``.pt``
branch of `detector_from_checkpoint`) against the JAX package's.

No real ``.pt`` is in the repository (and unpickling one needs the
``ultralytics`` package), so the tests build an Ultralytics-layout v8 state
dict from seeded weights with `chip_smoke.ultralytics_layout` (the inverse
of the documented mapping, held here to invert the JAX importer exactly)
and save it with ``torch.save`` as a plain state dict.

Tolerances: the imported models' head outputs (float32, 64 px) within 1e-4
of the largest logit; detections as `tests/test_torch_detect.py` holds
them (boxes 0.02 px, scores 1e-4, the same candidates and classes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from icp_slam_yolo_tpu.io import torch_import as jimport
from icp_slam_yolo_tpu.models import detect as jdetect
from icp_slam_yolo_tpu.models import yolo as jyolo
from icp_slam_yolo_tpu_torch.convert import detector_params_from_numpy
from icp_slam_yolo_tpu_torch.io import torch_import as timport
from icp_slam_yolo_tpu_torch.models import detect as tdetect
from icp_slam_yolo_tpu_torch.models import yolo as tyolo
from test_torch_yolo import SIZE, _flatten_outs, seeded_tree

torch.set_num_threads(2)


def _ultralytics(seed: int):
    params, stats = seeded_tree("detect", seed, num_classes=1)
    return params, stats, chip_smoke.ultralytics_layout(params, stats)


def _same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


def test_layout_inverts_the_jax_importer():
    """The state dict the tests use is the exact inverse of JAX's mapping."""
    params, stats, sd = _ultralytics(3)
    jp, js = jimport.convert_state_dict(sd)
    _same_tree(jp, params)
    _same_tree(js, stats)


@pytest.mark.parametrize("seed", [4, 5])
def test_imported_forward_matches_jax(seed):
    _, _, sd = _ultralytics(seed)
    jp, js = jimport.convert_state_dict(sd)
    x = np.random.default_rng(seed).random((2, SIZE, SIZE, 3)).astype(np.float32)
    want = jyolo.YOLO(num_classes=1).apply({"params": jp, "batch_stats": js}, jnp.asarray(x))
    model = tyolo.YOLO(num_classes=1, family="v8")
    state = timport.validate_against_model(timport.convert_state_dict(sd), model)
    assert all(v.shape == model.state_dict()[k].shape for k, v in state.items())
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    got, want = _flatten_outs(got), [np.asarray(w) for w in _flatten_outs(want)]
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * scale


def test_conv_weights_stay_oihw_and_dfl_is_skipped():
    _, _, sd = _ultralytics(6)
    state = timport.convert_state_dict(sd)
    assert np.array_equal(state["stem.conv.weight"].numpy(), sd["model.0.conv.weight"])
    assert np.array_equal(state["head.Conv_1.conv.bias"].numpy(), sd["model.22.cv3.0.2.bias"])
    assert not any("dfl" in k for k in state)
    bare = {k[len("model."):]: v for k, v in sd.items()}  # keys without the DetectionModel prefix
    assert set(timport.convert_state_dict(bare)) == set(state)


def test_refusals_raise_in_both():
    _, _, sd = _ultralytics(7)
    for convert in (jimport.convert_state_dict, timport.convert_state_dict):
        with pytest.raises(ValueError, match="only family='v8'"):
            convert(sd, family="v12")
        with pytest.raises(ValueError, match="unmapped torch keys"):
            convert({**sd, "model.23.extra.weight": np.zeros(3, np.float32)})
    wrong = dict(sd)
    wrong["model.1.conv.weight"] = np.zeros((32, 16, 5, 5), np.float32)
    jp, js = jimport.convert_state_dict(wrong)
    with pytest.raises(ValueError, match="shape mismatch"):
        jimport.validate_against_model(jp, js, jyolo.YOLO(num_classes=1))
    with pytest.raises(ValueError, match="shape mismatch"):
        timport.validate_against_model(timport.convert_state_dict(wrong), tyolo.YOLO(num_classes=1))
    missing = {k: v for k, v in sd.items() if not k.startswith("model.22.cv3.2.2")}
    for convert in (jimport.convert_state_dict, timport.convert_state_dict):
        with pytest.raises(KeyError, match="22.cv3.2.2.weight"):
            convert(missing)
    with pytest.raises(ValueError, match="tree mismatch"):
        timport.validate_against_model({**timport.convert_state_dict(sd), "neck.extra": torch.zeros(1)},
                                       tyolo.YOLO(num_classes=1))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_pt_file_detects_as_jax(fused, tmp_path):
    """A ``.pt`` written with ``torch.save`` through both packages'
    `detector_from_checkpoint`; the port's also equals its own detector
    built from the same weights as a flax tree."""
    params, stats, sd = _ultralytics(8)
    path = str(tmp_path / "v8.pt")
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, path)
    kw = dict(conf_threshold=1e-3, img_size=SIZE)
    tdet = tdetect.detector_from_checkpoint(path, compute_dtype=torch.float32, pallas_convs=fused, device="cpu", **kw)
    jdet = jdetect.detector_from_checkpoint(path, compute_dtype=jnp.float32, **kw)
    same = tdetect.Detector(params={"params": params, "batch_stats": stats}, compute_dtype=torch.float32,
                            pallas_convs=fused, device="cpu", **kw)
    assert tdet.model.family == "v8" and tdet.task == "detect" and tdet.model.fused == fused
    for seed in range(2):
        frame = np.random.default_rng(seed).uniform(0, 255, (96, 128, 3)).astype(np.uint8)
        got, want, ref = tdet(frame), jdet(frame), same(frame)
        assert len(got["boxes"]) == len(want["boxes"]) > 0
        np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.02)
        np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)
        np.testing.assert_array_equal(got["classes"], want["classes"])
        for key in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(got[key], ref[key])


def test_fold_state_dict_equals_the_flax_fold():
    params, stats, sd = _ultralytics(9)
    model = tyolo.YOLO(num_classes=1)
    folded = timport.fold_state_dict(timport.validate_against_model(timport.convert_state_dict(sd), model),
                                     tyolo.BN_EPS)
    fp, fs = tyolo.fold_batchnorm(params, stats)
    want = detector_params_from_numpy(fp, fs, tyolo.YOLO(num_classes=1, fold_bn=True))
    assert set(folded) == set(want)
    for k in want:
        assert torch.equal(folded[k], want[k]), k
