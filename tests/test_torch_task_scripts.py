"""The task recipes of the port (`scripts/torch_train_{obb,segment,pose}.py`)
on the CPU: their arguments and defaults against the JAX scripts'
(``scripts/train_{obb,segment,pose}.py``) plus ``--device``, and one seeded
step each on a small `chip_smoke.pallet_dataset` (64 px, batch 2): a finite
loss, a checkpoint with the JAX scripts' metadata, and the evaluation each
script runs."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_train_obb  # noqa: E402
import torch_train_pose  # noqa: E402
import torch_train_segment  # noqa: E402


def _defaults(text: str) -> dict:
    """Each option of an ``argparse`` parser in ``text`` (a script's source)
    with its default."""
    return dict(re.findall(r'add_argument\("(--[a-z-]+)"[^)]*?default=([^,)]+)', text))


@pytest.mark.parametrize("task", ["obb", "segment", "pose"])
def test_arguments_and_defaults_match_the_jax_scripts(task):
    """The same options with the same defaults (the dataset and output
    paths relative instead of absolute), plus ``--device``; ``--help``
    runs."""
    jax_src = open(os.path.join(REPO, "scripts", f"train_{task}.py")).read()
    ours_src = open(os.path.join(REPO, "scripts", f"torch_train_{task}.py")).read()
    want, got = _defaults(jax_src), _defaults(ours_src)
    assert set(got) == set(want) | {"--device"}
    flags = set(re.findall(r'add_argument\("(--[a-z-]+)"', jax_src))
    assert flags == set(re.findall(r'add_argument\("(--[a-z-]+)"', ours_src)) - {"--device"}
    for k, v in want.items():
        if k in ("--data", "--images", "--labels", "--out"):
            assert os.path.basename(v.strip('"')) == got[k].strip('"'), k
        else:
            assert got[k] == v, k
    r = subprocess.run([sys.executable, os.path.join(REPO, "scripts", f"torch_train_{task}.py"), "--help"],
                       capture_output=True, text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0 and "--device" in r.stdout and "--steps" in r.stdout, r.stderr


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = chip_smoke.pallet_dataset(str(tmp_path_factory.mktemp("d") / "pallets"), seed=4, n_train=5, n_val=2,
                                     h=96, w=128)
    poly = os.path.join(root, "poly")
    for split, src in (("training", "train"), ("val", "val")):
        os.makedirs(os.path.join(poly, split))
        os.symlink(os.path.join(root, src, "images"), os.path.join(poly, split, "images"))
        os.symlink(os.path.join(root, src, "labels_poly"), os.path.join(poly, split, "labels"))
    return root


SMALL = ["--img-size", "64", "--batch-size", "2", "--steps", "1", "--device", "cpu"]


def _finite(history, *keys):
    assert len(history) == 1
    for k in ("loss", *keys):
        assert np.isfinite(history[0][k]), k


def test_obb_one_step(data, tmp_path):
    out = torch_train_obb.run(torch_train_obb.parse_args(["--data", f"{data}/poly", "--out", str(tmp_path / "o"),
                                                          *SMALL]))
    _finite(out["history"], "loss_angle")
    assert json.load(open(str(tmp_path / "o") + ".json")) == {
        "img_size": 64, "num_classes": 1, "variant": "n", "task": "obb", "family": "v8", "steps": 1}


def test_segment_one_step(data, tmp_path):
    m = torch_train_segment.run(torch_train_segment.parse_args(
        ["--data", f"{data}/poly", "--out", str(tmp_path / "s"), *SMALL]))
    _finite(m.pop("history"), "loss_mask")
    assert json.load(open(str(tmp_path / "s") + ".metrics.json")) == m
    assert set(m) == {"mask_iou_mean", "mask_iou_p10", "n_val"} and m["n_val"] <= 2


def test_pose_one_step_then_eval_only(data, tmp_path):
    args = ["--images", f"{data}/train/images", "--labels", f"{data}/train/labels_pose", "--out", str(tmp_path / "p"),
            *SMALL]
    m = torch_train_pose.run(torch_train_pose.parse_args(args))
    _finite(m.pop("history"), "loss_kpt", "loss_kobj")
    assert m["n_val"] == 1 and m["img_size"] == 64  # 5 pairs: 4 train / 1 val
    assert set(m) == {"n_val", "detection_recall", "corner_err_mean_px", "corner_err_p90_px", "pck_0.1", "oks_mean",
                      "img_size"}
    again = torch_train_pose.run(torch_train_pose.parse_args(args + ["--eval-only"]))
    assert again.pop("history") == [] and again == m
