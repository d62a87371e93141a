"""The port's checkpoint writer (`io/checkpoint.save_checkpoint`) and the
weights' way back (`convert.detector_params_to_numpy`), against flax and
the JAX package.

A checkpoint the port writes is flax's bytes for the same trees (flax's
``msgpack_restore`` reads it, equal leaf for leaf) and the port reads it
back equal; the model -> tree -> model round trip gives equal bits and
flax's tree structure for every family and task; a checkpoint of a model
the port trained loads in the JAX package's ``detector_from_checkpoint``
and detects as the port's `Detector` does (boxes within 0.02 px, scores
within 1e-4, as `test_torch_detect.py` holds them)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import icp_slam_yolo_tpu_torch as port
from icp_slam_yolo_tpu.models import detect as jdetect
from icp_slam_yolo_tpu.models import yolo as jyolo
from icp_slam_yolo_tpu_torch.convert import detector_params_from_numpy, detector_params_to_numpy
from icp_slam_yolo_tpu_torch.io.checkpoint import load_checkpoint, msgpack_serialize, save_checkpoint
from icp_slam_yolo_tpu_torch.models import train as ttrain
from icp_slam_yolo_tpu_torch.models import yolo as tyolo

torch.set_num_threads(2)
SIZE = 64
CASES = [("v8", "detect"), ("v8", "obb"), ("v8", "segment"), ("v8", "pose"), ("v11", "obb"), ("v12", "detect")]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert set(la) == set(lb)
    for k, v in la.items():
        assert v.dtype == lb[k].dtype and v.shape == lb[k].shape and np.array_equal(v, lb[k]), k


@pytest.mark.parametrize("family, task", CASES)
def test_round_trip_gives_equal_bits_and_flax_structure(family, task):
    """Seeded random weights (`create_train_state`) -> flax trees -> a fresh
    model: the same bits; the trees have flax's scopes and shapes."""
    model = tyolo.YOLO(num_classes=2, family=family, task=task)
    ttrain.create_train_state(model, SIZE, seed=7, device="cpu")
    with torch.no_grad():  # statistics off their initial 0 / 1
        for name, buf in model.named_buffers():
            if "running" in name:
                buf.add_(torch.rand(buf.shape, generator=torch.Generator().manual_seed(len(name))))
    params, stats = detector_params_to_numpy(model)
    shapes = jax.eval_shape(jyolo.YOLO(num_classes=2, family=family, task=task).init, jax.random.key(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    want = {jax.tree_util.keystr(p): v.shape for p, v in jax.tree_util.tree_leaves_with_path(
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})}
    got = _leaves({"params": params, "batch_stats": stats})
    assert {k: v.shape for k, v in got.items()} == want
    assert all(v.dtype == np.float32 for v in got.values())
    again = tyolo.YOLO(num_classes=2, family=family, task=task)
    again.load_state_dict(detector_params_from_numpy(params, stats, again))
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    _trees_equal({"params": params, "batch_stats": stats},
                 dict(zip(("params", "batch_stats"), detector_params_to_numpy(again))))


def test_written_checkpoint_is_flax_bytes_and_reads_back(tmp_path):
    model = tyolo.YOLO(num_classes=1, family="v12")
    ttrain.create_train_state(model, SIZE, seed=2, device="cpu")
    params, stats = detector_params_to_numpy(model)
    meta = {"img_size": 64, "num_classes": 1, "variant": "n", "task": "detect", "family": "v12"}
    path = str(tmp_path / "sub" / "w.msgpack")
    save_checkpoint(path, params, stats, meta)
    data = open(path, "rb").read()
    assert data == serialization.to_bytes({"params": params, "batch_stats": stats})
    _trees_equal(serialization.msgpack_restore(data), {"params": params, "batch_stats": stats})
    payload, got_stats, got_meta = load_checkpoint(path)
    _trees_equal(payload, {"params": params, "batch_stats": stats})
    _trees_equal(got_stats, stats)
    assert got_meta == meta and json.load(open(path + ".json")) == meta
    save_checkpoint(str(tmp_path / "no_stats.msgpack"), {"a": np.zeros(2, np.float32)})  # batch_stats None -> {}
    payload, got_stats, got_meta = load_checkpoint(str(tmp_path / "no_stats.msgpack"))
    assert got_stats == {} and got_meta == {} and np.array_equal(payload["params"]["a"], np.zeros(2, np.float32))
    assert serialization.msgpack_restore(open(tmp_path / "no_stats.msgpack", "rb").read())["batch_stats"] == {}


def test_serializer_matches_flax_on_the_types_it_writes():
    rng = np.random.default_rng(0)
    tree = {"z": {"k": rng.standard_normal((3, 3, 4, 5)).astype(np.float32), "b": np.zeros(5, np.float32)},
            "y" * 40: {"s": np.float32(3.0), "0d": np.ones((), np.float32), "big": rng.random((300, 70)).astype(np.float32),
                       "i": np.arange(7, dtype=np.int32), "f64": rng.random(3)},
            **{f"k{i}": np.ones(1, np.float32) for i in range(20)}, "empty": {}}
    assert msgpack_serialize(tree) == serialization.to_bytes(tree)


def test_port_trained_checkpoint_detects_in_jax_as_in_the_port(tmp_path):
    """Two CPU train steps of the port (v8 detect, 64 px), saved; JAX's
    `detector_from_checkpoint` and the port's detect the same on a frame."""
    rng = np.random.default_rng(1)
    batch = {"images": torch.from_numpy(rng.random((2, SIZE, SIZE, 3)).astype(np.float32)),
             "boxes": torch.tensor([[[8.0, 8, 40, 40], [30, 20, 62, 50]]] * 2), "classes": torch.zeros((2, 2), dtype=torch.int32),
             "valid": torch.ones((2, 2), dtype=torch.bool)}
    model = tyolo.YOLO(num_classes=1)
    state, _ = ttrain.fit(model, iter(lambda: batch, None), SIZE, 2, log_every=100, device="cpu")
    path = str(tmp_path / "trained.msgpack")
    save_checkpoint(path, *detector_params_to_numpy(state.model),
                    meta={"img_size": SIZE, "num_classes": 1, "variant": "n", "task": "detect", "family": "v8"})
    frame = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    j = jdetect.detector_from_checkpoint(path, conf_threshold=1e-3, compute_dtype=jnp.float32, pallas_convs=False)
    t = port.detector_from_checkpoint(path, conf_threshold=1e-3, compute_dtype=torch.float32, device="cpu")
    want, got = j(frame), t(frame)
    assert len(want["boxes"]) > 0 and len(got["boxes"]) == len(want["boxes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.02)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)
    assert np.array_equal(got["classes"], want["classes"])
