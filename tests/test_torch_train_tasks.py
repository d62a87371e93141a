"""One train step of the port against the JAX package's for the other
families and tasks: v11 obb and v8 segment here (v12 detect and v8 pose in
`test_torch_train_families.py`, a bfloat16 v8 step in
`test_torch_train_bf16.py`).

64 px, batch 2, one state on both sides (the JAX package's initial weights
carried across by `convert`), float64 on both sides as in
`test_torch_train.py` (the losses float32 in both packages): the task's
loss terms within 1e-4 relative; each gradient leaf within 2e-5 of its
norm plus 1e-12 of the global norm, and each parameter leaf's change
within 2e-5 of JAX's change plus 1e-9 (measured at most 3.2e-6 over the
four tasks); every parameter leaf within 1e-3 and every BatchNorm
statistic leaf within 1e-5 of its norm after the step, plus 1e-9.  The
floors are for the v11/v12 attention blocks' BatchNorm biases, whose
gradient cancels: they come out of the step at ~1e-21, rounding noise on
both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_slam_yolo_tpu.models import train as jtrain
from icp_slam_yolo_tpu.models import yolo as jyolo
from icp_slam_yolo_tpu_torch.convert import detector_params_from_numpy
from icp_slam_yolo_tpu_torch.models import train as ttrain
from icp_slam_yolo_tpu_torch.models import yolo as tyolo
from test_torch_train import (GRAD_FLOOR, _flat, _leaf_err, _np_tree, _port_leaves, grad_keeping, keep_port_grads,
                              worst_ratio)

torch.set_num_threads(2)
SIZE, B, M = 64, 2, 3


def task_batch(task, seed=0):
    """A batch with the task's labels: boxes (two valid a image), OBB angles,
    masks at the proto resolution (16 x 16) or four keypoints (one hidden)."""
    rng = np.random.default_rng(seed)
    boxes = np.array([[[8, 8, 40, 40], [30, 20, 62, 50], [0, 0, 0, 0]]] * B, np.float32)
    boxes[:, :2] += rng.uniform(-4, 2, (B, 2, 4)).astype(np.float32)
    batch = {"images": rng.random((B, SIZE, SIZE, 3)).astype(np.float32), "boxes": boxes,
             "classes": np.zeros((B, M), np.int32), "valid": np.array([[True, True, False]] * B)}
    if task == "obb":
        batch["angles"] = rng.uniform(-0.7, 2.3, (B, M)).astype(np.float32)
    elif task == "segment":
        ys, xs = np.mgrid[0:16, 0:16] + 0.5
        b4 = boxes / 4.0
        batch["masks"] = ((xs >= b4[..., 0, None, None]) & (xs < b4[..., 2, None, None])
                          & (ys >= b4[..., 1, None, None]) & (ys < b4[..., 3, None, None])).astype(np.float32)
    elif task == "pose":
        c = np.stack([boxes[..., [0, 1]], boxes[..., [2, 1]], boxes[..., [2, 3]], boxes[..., [0, 3]]], 2)
        vis = np.ones((B, M, 4, 1), np.float32)
        vis[:, :, 3] = 0.0
        batch["kpts"] = np.concatenate([c + rng.normal(0, 1.0, c.shape), vis], -1).astype(np.float32)
    return batch


def jax_step(family, task, dtype, steps=1):
    """``(initial params, stats, metrics per step, leaves after the steps,
    gradients per step)`` of the JAX package's train step; float64 runs
    under ``enable_x64``."""
    model = jyolo.YOLO(num_classes=1, family=family, task=task)
    state, _ = jtrain.create_train_state(model, SIZE, total_steps=steps)
    p0, s0 = _np_tree(state.params), _np_tree(state.batch_stats)
    cast = "float32" if dtype == "bfloat16" else dtype
    with jax.enable_x64(dtype == "float64"):
        m = jyolo.YOLO(num_classes=1, family=family, task=task, compute_dtype=jnp.dtype(dtype))
        tx = grad_keeping(jtrain.make_optimizer(total_steps=steps))
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, cast), p0)
        st = jtrain.TrainState(params, jax.tree_util.tree_map(lambda a: jnp.asarray(a, cast), s0), tx.init(params),
                               jnp.int32(0))
        step = jax.jit(jtrain.make_train_step(m, tx, SIZE))
        batch = {k: jnp.asarray(v) for k, v in task_batch(task).items()}
        metrics, grads = [], []
        for _ in range(steps):
            st, met = step(st, batch)
            metrics.append({k: float(v) for k, v in met.items()})
            grads.append(_flat({"params": _np_tree(st.opt_state[1])}))
        leaves = _flat({"params": _np_tree(st.params), "batch_stats": _np_tree(st.batch_stats)})
    return p0, s0, metrics, leaves, grads


def port_step(family, task, dtype, p0, s0, steps=1):
    tdt = getattr(torch, dtype)
    model = tyolo.YOLO(num_classes=1, family=family, task=task, compute_dtype=tdt)
    model.load_state_dict(detector_params_from_numpy(p0, s0, model))
    if dtype == "float64":
        model.double()
    state = ttrain.TrainState(model, ttrain.make_optimizer(model, total_steps=steps))
    grads = keep_port_grads(model, state.optimizer)
    step = ttrain.make_train_step(model, state.optimizer, SIZE)
    batch = {k: torch.from_numpy(v) for k, v in task_batch(task).items()}
    metrics = []
    for _ in range(steps):
        state, met = step(state, batch)
        metrics.append({k: float(v) for k, v in met.items()})
    return metrics, _port_leaves(model), grads


def check_float64_step(family, task):
    p0, s0, want_m, want, want_g = jax_step(family, task, "float64")
    got_m, got, got_g = port_step(family, task, "float64", p0, s0)
    assert set(got_m[0]) == set(want_m[0])
    assert got_m[0]["num_fg"] == want_m[0]["num_fg"] > 0
    for k, v in want_m[0].items():
        np.testing.assert_allclose(got_m[0][k], v, rtol=1e-4, atol=1e-8, err_msg=k)
    ratio, path = worst_ratio(got_g[0], want_g[0], GRAD_FLOOR * want_m[0]["grad_norm"])
    assert ratio <= 2e-5, ("gradient", path, ratio)
    assert set(got) == set(want)
    for path, leaf in got.items():
        tol = 1e-3 if path[0] == "params" else 1e-5
        assert _leaf_err(want[path], leaf) <= tol * np.linalg.norm(want[path]) + 1e-9, path
    params = {p: v for p, v in want.items() if p[0] == "params"}
    ratio, path = worst_ratio(got, params, 1e-9, base=_flat({"params": p0}))
    assert ratio <= 2e-5, ("change", path, ratio)


@pytest.mark.parametrize("family, task", [("v11", "obb"), ("v8", "segment")])
def test_one_step_matches_jax(family, task):
    check_float64_step(family, task)
