"""The port's checkpoint reader (its own msgpack decoder) against flax's
``msgpack_restore`` on every checkpoint in ``checkpoints/``, leaf for leaf;
the segment mask assembly against the JAX package's."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from icp_slam_yolo_tpu.models import segment as jseg
from icp_slam_yolo_tpu_torch.io import checkpoint as tckpt
from icp_slam_yolo_tpu_torch.models import segment as tseg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "checkpoints", "*.msgpack")))


def test_there_are_eight_checkpoints():
    assert len(CHECKPOINTS) == 8


@pytest.mark.parametrize("name", [
    "pallet_detect_640.msgpack", "pallet_detect_v12_640.msgpack", "pallet_obb_1024.msgpack", "pallet_obb_640.msgpack",
    "pallet_obb_v11_640.msgpack", "pallet_pose_640.msgpack", "pallet_segment_320.msgpack", "pallet_segment_640.msgpack"])
def test_reader_equals_flax_leaf_for_leaf(name):
    path = os.path.join(REPO, "checkpoints", name)
    payload, batch_stats, meta = tckpt.load_checkpoint(path)
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got_leaves = jax.tree_util.tree_leaves_with_path(payload)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves] and len(got_leaves) > 100
    for (_, g), (_, w) in zip(got_leaves, want_leaves):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert batch_stats is payload["batch_stats"]
    with open(path + ".json") as f:
        assert meta == json.load(f)


def test_decoder_round_trips_the_types_flax_writes():
    tree = {
        "a": {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "h": np.ones((2, 2), np.float16)},
        "n": 7, "neg": -3, "big": 2 ** 40, "f": 1.5, "s": "text" * 20, "t": True, "none": None,
        "i8": np.arange(5, dtype=np.int8), "scalar": np.float32(2.5), "empty": {}, "z": np.zeros((0, 3), np.int32),
        "wide": {f"k{i}": i for i in range(20)},  # a map16
    }
    got = tckpt.msgpack_restore(serialization.msgpack_serialize(tree))
    want = serialization.msgpack_restore(serialization.msgpack_serialize(tree))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert type(g) is type(w)
        np.testing.assert_array_equal(g, w)


def test_decoder_rejects_truncated_and_trailing_data():
    data = serialization.msgpack_serialize({"a": np.arange(4, dtype=np.float32)})
    with pytest.raises(ValueError):
        tckpt.msgpack_restore(data[:-3])
    with pytest.raises(ValueError):
        tckpt.msgpack_restore(data + b"\x00")


def test_assemble_masks_matches_jax():
    rng = np.random.default_rng(0)
    protos = rng.standard_normal((16, 16, 8)).astype(np.float32)
    coeffs = rng.standard_normal((5, 8)).astype(np.float32)
    boxes = np.array([[4, 4, 40, 40], [0, 0, 64, 64], [10, 20, 30, 25], [50, 50, 50, 50], [-5, 3, 20, 70]], np.float32)
    want = jseg.assemble_masks(jnp.asarray(protos), jnp.asarray(coeffs), jnp.asarray(boxes), 64)
    got = tseg.assemble_masks(torch.from_numpy(protos), torch.from_numpy(coeffs), torch.from_numpy(boxes), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    mask = np.asarray(want[0])
    np.testing.assert_array_equal(tseg.mask_to_polygon(mask), jseg.mask_to_polygon(mask))
    assert tseg.masks_to_label_rows(np.asarray(want), np.zeros(5, int), 64) == \
        jseg.masks_to_label_rows(np.asarray(want), np.zeros(5, int), 64)
