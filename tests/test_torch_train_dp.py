"""The data-parallel train step (`models/train.make_train_step(...,
mesh=...)`) over two spawned gloo ranks (`torch_dist_workers.Ranks`),
each on its block of a global batch of 4: v8 detect, and v8 segment for
its mean over the images, 64 px, float64 (8 values a channel at stride 32
amplify float32 rounding in train-mode BatchNorm), two steps.

Held against:
  * the port's one-process step on the whole batch.  What differs is the
    order of the sums (each rank's share, then the ranks).  In float64
    that leaves the BatchNorm statistics of the first step (the global
    batch's moments, a float64 forward) within 1e-12 of each leaf's norm.
    The loss is float32 in both packages (the head outputs are cast before
    it), and its normaliser ``sum(target scores)`` is a float32 sum, which
    two ranks round differently from one process by an ulp or so; every
    gradient is divided by it.  So the updates agree to float32's
    precision, not float64's: each parameter's change over the two steps
    within 2e-6 of the one-process change (plus 1e-12), ``grad_norm``
    within 2e-6 relative, the statistics after both steps within 1e-7 of
    their norm, the float32 loss terms within 8 float32 ulps, ``num_fg``
    equal (measured: 5.1e-7, 2.5e-7, 1.8e-8 and 1.4 ulps);
  * JAX's ``make_train_step`` under ``jit`` with the batch sharded over a
    2-device mesh and the state replicated (its ``dryrun_train_step``
    layout): the losses within 1e-4 relative (float32 in both packages),
    ``num_fg`` equal, the BatchNorm statistics within 1e-5 of each leaf's
    norm and each parameter's change within 1e-5 of JAX's change plus
    1e-9, as `test_torch_train.py` and `test_torch_train_tasks.py` hold the
    one-process float64 step;
  * the other rank: parameters and statistics bit-identical after every
    step, and the same metrics.
Then ``dryrun_train_step(2)`` runs on the two ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from icp_slam_yolo_tpu.models import train as jtrain
from icp_slam_yolo_tpu.models import yolo as jyolo
from icp_slam_yolo_tpu.parallel.mesh import make_mesh
from icp_slam_yolo_tpu_torch.convert import detector_params_to_numpy, flax_leaves
from icp_slam_yolo_tpu_torch.models import train as ttrain
from icp_slam_yolo_tpu_torch.models import yolo as tyolo
from test_torch_train import _flat, _leaf_err, _np_tree
import torch_dist_workers as workers

torch.set_num_threads(2)
SIZE, B, M, STEPS = 64, 4, 3, 2
LOSS_ULPS = 8  # the float32 loss terms against the one-process step's


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    ranks = workers.Ranks(2, tmp_path_factory.mktemp("store"), timeout=300.0)
    yield ranks
    ranks.close()


def _batch(task: str) -> dict:
    """A seeded global batch of 4: two valid boxes an image, one of them on
    images 0-1 only (the ranks' shares of the normaliser differ), and for
    segment the boxes' masks at the proto resolution."""
    rng = np.random.default_rng(5)
    boxes = np.array([[[8, 8, 40, 40], [30, 20, 62, 50], [0, 0, 0, 0]]] * B, np.float32)
    boxes[:, :2] += rng.uniform(-4, 2, (B, 2, 4)).astype(np.float32)
    valid = np.array([[True, True, False]] * 2 + [[True, False, False]] * 2)
    batch = {"images": rng.random((B, SIZE, SIZE, 3)), "boxes": boxes, "classes": np.zeros((B, M), np.int32),
             "valid": valid}
    if task == "segment":
        ys, xs = np.mgrid[0:16, 0:16] + 0.5
        b4 = boxes / 4.0
        batch["masks"] = ((xs >= b4[..., 0, None, None]) & (xs < b4[..., 2, None, None])
                          & (ys >= b4[..., 1, None, None]) & (ys < b4[..., 3, None, None])).astype(np.float32)
    return batch


def _jax_sharded(task: str, p0, s0):
    """Two JAX steps, float64, the batch sharded over a 2-device mesh:
    the metrics of each and the leaves after them."""
    with jax.enable_x64(True):
        model = jyolo.YOLO(num_classes=1, task=task, compute_dtype=jnp.float64)
        tx = jtrain.make_optimizer(total_steps=STEPS)
        mesh = make_mesh(2)
        data, repl = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), p0)
        st = jtrain.TrainState(params, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), s0),
                               tx.init(params), jnp.int32(0))
        st = jax.device_put(st, repl)
        batch = {k: jax.device_put(jnp.asarray(v), data) for k, v in _batch(task).items()}
        step = jax.jit(jtrain.make_train_step(model, tx, SIZE), out_shardings=(repl, None))
        metrics = []
        for _ in range(STEPS):
            st, met = step(st, batch)
            metrics.append({k: float(v) for k, v in met.items()})
        return metrics, _flat({"params": _np_tree(st.params), "batch_stats": _np_tree(st.batch_stats)})


def _port_leaves(state: dict, model) -> dict:
    """A state dict's leaves by flax path, HWIO kernels."""
    out = {}
    for key, path, kernel in flax_leaves(model):
        t = np.asarray(state[key], np.float64)
        out[path] = t.transpose(2, 3, 1, 0) if kernel else t
    return out


@pytest.mark.parametrize("task", ["detect", "segment"])
def test_data_parallel_step(ranks2, task):
    model = tyolo.YOLO(num_classes=1, task=task, compute_dtype=torch.float64)
    ttrain.create_train_state(model, SIZE, seed=4, device="cpu")  # flax's initial distributions, drawn by the port
    p0, s0 = detector_params_to_numpy(model)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    ranks2.submit(workers.train_step, "v8", task, sd0, _batch(task), STEPS)
    want_metrics, want = _jax_sharded(task, p0, s0)
    model.load_state_dict(sd0)
    model.double()
    state = ttrain.TrainState(model, ttrain.make_optimizer(model, total_steps=STEPS))
    step = ttrain.make_train_step(model, state.optimizer, SIZE)
    batch = {k: torch.from_numpy(v) for k, v in _batch(task).items()}
    one_metrics = []
    for i in range(STEPS):
        state, m = step(state, batch)
        one_metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            one_first = _port_leaves({k: v.clone() for k, v in model.state_dict().items()}, model)
    got = ranks2.collect(workers.train_step)

    for mine, other in zip(got[0]["states"], got[1]["states"]):  # the ranks apply the same update
        for k, v in mine.items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)
    assert got[0]["metrics"] == got[1]["metrics"]

    ranks = _port_leaves(got[0]["states"][-1], model)
    first = _port_leaves(got[0]["states"][0], model)
    for path, leaf in first.items():
        if path[0] == "batch_stats":
            assert _leaf_err(one_first[path], leaf) <= 1e-12 * np.linalg.norm(one_first[path]), path
    one, start = _port_leaves(model.state_dict(), model), _flat({"params": p0})
    for path, leaf in ranks.items():
        if path[0] == "params":
            change = one[path] - start[path]
            assert _leaf_err(change, leaf - start[path]) <= 2e-6 * np.linalg.norm(change) + 1e-12, path
        else:
            assert _leaf_err(one[path], leaf) <= 1e-7 * np.linalg.norm(one[path]), path
    for w, g in zip(one_metrics, got[0]["metrics"]):
        assert set(w) == set(g) and g["num_fg"] == w["num_fg"] > 0
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 2e-6 * w["grad_norm"]
        for k in (k for k in w if k.startswith("loss")):
            assert abs(g[k] - w[k]) <= LOSS_ULPS * np.finfo(np.float32).eps * abs(w[k]), (k, g[k], w[k])

    for w, g in zip(want_metrics, got[0]["metrics"]):
        assert set(w) == set(g) and g["num_fg"] == w["num_fg"]
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, rtol=1e-4, atol=1e-8, err_msg=k)
    for path, leaf in ranks.items():
        if path[0] == "params":
            bound = 1e-5 * np.linalg.norm(want[path] - start[path]) + 1e-9
            assert _leaf_err(want[path] - start[path], leaf - start[path]) <= bound, path
        else:
            assert _leaf_err(want[path], leaf) <= 1e-5 * np.linalg.norm(want[path]), path


def test_dryrun_train_step_on_two_ranks(ranks2):
    """JAX's dry run, data-parallel on two ranks: a finite loss, the ranks'
    parameters equal (checked inside), the same metrics on both."""
    got = ranks2.run(workers.dryrun, 2)
    assert got[0] == got[1] and np.isfinite(got[0]["loss"]) and got[0]["num_fg"] > 0
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        ttrain.dryrun_train_step(2, device="cpu")
