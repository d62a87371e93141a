"""The port's training (`models/train.py`) against the JAX package's: the
learning-rate schedule, the optimizer chain, the initial weights, three v8
train steps, the results CSV and `fit`.

The train steps run at 64 px, batch 2, from one state (the JAX package's
initial weights carried across by `convert`), twice.  Each step's
gradients are compared leaf by leaf: the JAX step's are kept by its
optimizer (`grad_keeping`), the port's as its optimizer is handed them
(`keep_port_grads`), each within a tolerance of that leaf's gradient norm
plus 1e-12 of the global norm (`GRAD_FLOOR`).
  * in float32, as the CLI trains: each step's loss within 1e-4 relative;
    each gradient leaf within 1e-2 of its norm at step 1 and 1e-1 at steps
    2-3 (measured 1.7e-3, 4.7e-3, 2.9e-2); each parameter leaf within
    ``1e-3 |p| + 0.05 |p - p0|`` and each BatchNorm statistic leaf within
    1e-2 of its norm after the three steps.  Train-mode BatchNorm normalises with the batch's statistics,
    and at the stride-32 level that is 8 values a channel, which amplifies
    float32 rounding: JAX's float32 forward was measured ~6x further from a
    float64 forward than the port's, and the leaves it moves most are the
    zero-started BatchNorm biases there (1-2 % of their updates);
  * in float64 on both sides (JAX under ``enable_x64``, the losses still
    float32 as both packages cast the head outputs), which leaves the
    semantics alone: the losses within 1e-4 relative; each gradient leaf
    within 2e-5 of its norm at step 1 and 5e-4 at steps 2-3 (measured
    1.3e-6, 1.0e-5, 5.9e-5: the parameters differ by the earlier steps'
    rounding); every parameter leaf within 1e-3 of its norm, and its
    change over the three steps within 1e-3 of JAX's change plus 1e-9
    (measured 1.2e-4); the BatchNorm statistics within 1e-5 of each leaf's
    norm after the first step (an unbiased running variance would be 14 %
    off at the stride-32 level) and 1e-4 after the third.  A leaf whose
    JAX gradient is 0 at this size (the box branch of a level no
    foreground anchor falls on) must be 0 in the port too."""

import csv
import io
import math

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icp_slam_yolo_tpu.models import train as jtrain
from icp_slam_yolo_tpu.models import yolo as jyolo
from icp_slam_yolo_tpu_torch.convert import detector_params_from_numpy, flax_leaves
from icp_slam_yolo_tpu_torch.models import train as ttrain
from icp_slam_yolo_tpu_torch.models import yolo as tyolo

torch.set_num_threads(2)
SIZE, B, STEPS = 64, 2, 3
# the gradient comparisons' absolute floor, over the global gradient norm: a leaf whose gradient cancels (the
# v11/v12 attention blocks' bare BatchNorm biases) holds rounding noise on both sides
GRAD_FLOOR = 1e-12


def _batch():
    rng = np.random.default_rng(0)
    return {"images": rng.random((B, SIZE, SIZE, 3)).astype(np.float32),
            "boxes": np.array([[[8, 8, 40, 40], [30, 20, 62, 50], [0, 0, 0, 0]]] * B, np.float32),
            "classes": np.zeros((B, 3), np.int32), "valid": np.array([[True, True, False]] * B)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {tuple(p.key for p in path): np.asarray(v) for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(model):
    """The model's leaves by flax path, HWIO kernels."""
    sd = model.state_dict()
    out = {}
    for key, path, kernel in flax_leaves(model):
        t = np.array(sd[key].detach().double().numpy())  # a copy: the model moves on
        out[path] = t.transpose(2, 3, 1, 0) if kernel else t
    return out


def grad_keeping(tx):
    """``tx`` that also keeps the gradients of its last update in its
    state (``state[1]``): the JAX step's own per-leaf gradients, from the
    step that is run anyway."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def keep_port_grads(model, optimizer) -> list:
    """Makes ``optimizer.step`` first append the gradients it is given (the
    unclipped ones; zero where none reached a parameter) to the returned
    list, one dict a step by flax path, kernels HWIO."""
    kept, update = [], optimizer.step
    leaves = {key: (path, kernel) for key, path, kernel in flax_leaves(model)}

    def step():
        grads = {}
        for name, p in model.named_parameters():
            path, kernel = leaves[name]
            g = np.zeros(p.shape) if p.grad is None else np.array(p.grad.detach().double().numpy())
            grads[path] = g.transpose(2, 3, 1, 0) if kernel else g
        kept.append(grads)
        return update()

    optimizer.step = step
    return kept


@pytest.fixture(scope="module")
def jax_v8_runs():
    """Three JAX train steps from the initial state, float32 and float64:
    ``(initial params, initial stats, {dtype: (per-step metrics, stats
    after step 1, params and stats after step 3, per-step gradients)})``."""
    model = jyolo.YOLO(num_classes=1)
    state, _ = jtrain.create_train_state(model, SIZE, total_steps=STEPS)
    p0, s0 = _np_tree(state.params), _np_tree(state.batch_stats)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    runs = {}
    for dt in ("float32", "float64"):
        with jax.enable_x64(dt == "float64"):
            m = jyolo.YOLO(num_classes=1, compute_dtype=jnp.dtype(dt))
            tx = grad_keeping(jtrain.make_optimizer(total_steps=STEPS))
            params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), p0)
            st = jtrain.TrainState(params, jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), s0), tx.init(params),
                                   jnp.int32(0))
            step = jax.jit(jtrain.make_train_step(m, tx, SIZE))
            metrics, first_stats, grads = [], None, []
            for i in range(STEPS):
                st, met = step(st, batch)
                metrics.append({k: float(v) for k, v in met.items()})
                grads.append(_flat({"params": _np_tree(st.opt_state[1])}))
                if i == 0:
                    first_stats = _flat({"batch_stats": _np_tree(st.batch_stats)})
            runs[dt] = (metrics, first_stats, _flat({"params": _np_tree(st.params), "batch_stats": _np_tree(st.batch_stats)}),
                        grads)
    return p0, s0, runs


def _port_run(p0, s0, dtype):
    model = tyolo.YOLO(num_classes=1, compute_dtype=dtype)
    model.load_state_dict(detector_params_from_numpy(p0, s0, model))
    model.to(dtype)
    state = ttrain.TrainState(model, ttrain.make_optimizer(model, total_steps=STEPS))
    grads = keep_port_grads(model, state.optimizer)
    step = ttrain.make_train_step(model, state.optimizer, SIZE)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    metrics, first_stats = [], None
    for i in range(STEPS):
        state, met = step(state, batch)
        metrics.append({k: float(v) for k, v in met.items()})
        if i == 0:
            first_stats = {p: v for p, v in _port_leaves(model).items() if p[0] == "batch_stats"}
    return metrics, first_stats, _port_leaves(model), grads


def _leaf_err(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b))


def worst_ratio(got: dict, want: dict, floor: float = 0.0, base: dict | None = None):
    """``(max over leaves of |got - want| / (|want - base| + floor), that
    leaf's path)``: how far each leaf is from JAX's relative to its own size
    (or, with ``base``, to its own change from ``base``)."""
    ratios = {}
    for path, w in want.items():
        w = np.asarray(w, np.float64)
        size = np.linalg.norm(w - (0.0 if base is None else base[path]))
        ratios[path] = _leaf_err(w, got[path]) / (size + floor)
    path = max(ratios, key=ratios.get)
    return ratios[path], path


@pytest.mark.parametrize("total", [1, 3, 10, 57, 1500, 10000])
def test_schedule_matches_optax(total):
    """optax's warm-up + cosine schedule at every update count (and past
    the end), with the JAX package's warm-up rule."""
    lr = 0.01
    warmup = min(100, max(total // 10, 1))
    want = optax.warmup_cosine_decay_schedule(init_value=lr * 0.1, peak_value=lr, warmup_steps=warmup,
                                              decay_steps=max(total, warmup + 1), end_value=lr * 0.01)
    got = ttrain.lr_schedule(lr, 100, total)
    counts = sorted(set(range(0, min(total, 300) + 5)) | {total - 1, total, total + 3})
    for c in counts:
        np.testing.assert_allclose(got(c), float(want(c)), rtol=2e-6, err_msg=f"count {c}")
    assert got(0) == pytest.approx(lr * 0.1)


@pytest.mark.parametrize("family", ["v8", "v12"])
def test_optimizer_matches_the_optax_chain(family):
    """Five updates on seeded gradients, global norms 81 (clipped) and 3.3
    (not), against the JAX package's `make_optimizer`: each leaf within
    2e-6 of its norm; the returned norm is the unclipped one.  Then the
    decay mask leaf by leaf: with zero gradients, a leaf moves under optax
    exactly when the port decays it (kernels, depthwise kernels, the A2C2f
    gamma; not biases or BatchNorm scales)."""
    shapes = jax.eval_shape(jyolo.YOLO(num_classes=1, family=family).init, jax.random.key(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.default_rng(2)
    p0, s0 = (jax.tree_util.tree_map(lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32), shapes[k])
              for k in ("params", "batch_stats"))
    model = tyolo.YOLO(num_classes=1, family=family)
    model.load_state_dict(detector_params_from_numpy(p0, s0, model))
    paths = {key: path for key, path, _ in flax_leaves(model)}
    tx = jtrain.make_optimizer(total_steps=7)
    opt = ttrain.make_optimizer(model, total_steps=7)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    ost = tx.init(params)

    @jax.jit
    def update(g, ost, params):
        updates, ost = tx.update(g, ost, params)
        return optax.apply_updates(params, updates), ost

    rng = np.random.default_rng(1)
    for it in range(5):
        scale = 0.05 if it % 2 == 0 else 0.002
        grads = jax.tree_util.tree_map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32), p0)
        params, ost = update(jax.tree_util.tree_map(jnp.asarray, grads), ost, params)
        flat_g = _flat(grads)
        for name, p in model.named_parameters():
            g = flat_g[paths[name][1:]]
            p.grad = torch.from_numpy(np.array(g.transpose(3, 2, 0, 1) if g.ndim == 4 else g))
        norm = float(opt.step())
        assert norm == pytest.approx(float(optax.global_norm(grads)), rel=1e-5)
        assert (norm > 10) == (it % 2 == 0)
        want = _flat({"params": _np_tree(params)})
        for path, got in _port_leaves(model).items():
            if path[0] == "params":
                assert _leaf_err(want[path], got) <= 2e-6 * np.linalg.norm(want[path]), (it, path)

    zero = jax.tree_util.tree_map(jnp.zeros_like, params)
    moved, _ = jax.jit(tx.update)(zero, tx.init(params), params)
    moved = _flat({"params": _np_tree(moved)})
    decays = ttrain.decay_mask(model)
    for name, _ in model.named_parameters():
        assert decays[name] == bool(np.any(moved[paths[name]] != 0)), name
    assert any(decays[n] for n in decays if n.endswith("gamma")) == (family == "v12")


def test_initial_weights_follow_flax_distributions():
    """`create_train_state` draws lecun-normal (truncated at 2 sigma) conv
    kernels: each layer of at least 4096 weights within 5 % of std
    ``sqrt(1 / fan_in)`` (flax's own layers are held to the same), none
    beyond the cut; biases 0, BatchNorm scale 1 and statistics 0 / 1; the
    class branches' biases -4.6 and the A2C2f scales 0.01 exactly."""
    model = tyolo.YOLO(num_classes=1, family="v12")
    state = ttrain.create_train_state(model, SIZE, seed=3, device="cpu")
    assert state.model is model and state.step == 0
    paths = {key: path for key, path, _ in flax_leaves(model)}
    lecun = flax.linen.initializers.lecun_normal()  # flax's kernel_init for every Conv
    checked = 0
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            w = mod.weight.detach().numpy()
            std = math.sqrt(1.0 / (w.shape[1] * w.shape[2] * w.shape[3]))
            assert np.abs(w).max() <= 2.0 * std / ttrain.TRUNC_STD + 1e-7
            if w.size >= 4096:
                assert abs(w.std() / std - 1) < 0.05, name
                kernel = np.asarray(lecun(jax.random.key(checked), w.transpose(2, 3, 1, 0).shape))
                assert abs(kernel.std() / std - 1) < 0.05, name
                checked += 1
    assert checked > 20
    cls_bias = {f"head.{cls[2]}.conv.bias" for _, cls in model.head._levels}
    for name, p in model.named_parameters():
        v = p.detach().numpy()
        if name in cls_bias:
            assert (v == np.float32(-4.6)).all()
        elif name.endswith("gamma"):
            assert (v == np.float32(0.01)).all()
        elif name.endswith("bias"):
            assert (v == 0).all(), name
        elif name.endswith("bn.weight") or (name.endswith("weight") and p.dim() == 1):
            assert (v == 1).all(), name
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            assert (buf == 0).all()
        elif name.endswith("running_var"):
            assert (buf == 1).all()
    again = ttrain.create_train_state(tyolo.YOLO(num_classes=1, family="v12"), SIZE, seed=3, device="cpu").model
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), again.state_dict().values()))


def test_v8_float32_steps_match_jax(jax_v8_runs):
    p0, s0, runs = jax_v8_runs
    want_metrics, _, want_final, want_grads = runs["float32"]
    got_metrics, _, got_final, got_grads = _port_run(p0, s0, torch.float32)
    for w, g in zip(want_metrics, got_metrics):
        assert g["num_fg"] == w["num_fg"] > 0
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-3)
    for i, (want, got) in enumerate(zip(want_grads, got_grads)):
        ratio, path = worst_ratio(got, want, GRAD_FLOOR * want_metrics[i]["grad_norm"])
        assert ratio <= (1e-2 if i == 0 else 1e-1), (i + 1, path, ratio)
    start = _flat({"params": p0})
    for path, got in got_final.items():
        want = want_final[path]
        if path[0] == "params":
            bound = 1e-3 * np.linalg.norm(want) + 0.05 * np.linalg.norm(want - start[path])
        else:
            bound = 1e-2 * np.linalg.norm(want)
        assert _leaf_err(want, got) <= bound, path


def test_v8_float64_steps_match_jax(jax_v8_runs):
    p0, s0, runs = jax_v8_runs
    want_metrics, want_first, want_final, want_grads = runs["float64"]
    got_metrics, got_first, got_final, got_grads = _port_run(p0, s0, torch.float64)
    for w, g in zip(want_metrics, got_metrics):
        assert g["num_fg"] == w["num_fg"] > 0
        for k in ("loss", "loss_box", "loss_cls", "loss_dfl", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    for i, (want, got) in enumerate(zip(want_grads, got_grads)):
        ratio, path = worst_ratio(got, want, GRAD_FLOOR * want_metrics[i]["grad_norm"])
        assert ratio <= (2e-5 if i == 0 else 5e-4), (i + 1, path, ratio)
    for path, got in got_first.items():
        assert _leaf_err(want_first[path], got) <= 1e-5 * np.linalg.norm(want_first[path]), path
    for path, got in got_final.items():
        tol = 1e-3 if path[0] == "params" else 1e-4
        assert _leaf_err(want_final[path], got) <= tol * np.linalg.norm(want_final[path]), path
    params = {p: v for p, v in want_final.items() if p[0] == "params"}
    ratio, path = worst_ratio(got_final, params, 1e-9, base=_flat({"params": p0}))
    assert ratio <= 1e-3, (path, ratio)


def test_inference_after_training_reads_the_trained_weights():
    """The inference memo is dropped at ``train()``/``eval()`` and at a
    reload: a model whose memo was filled before `fit` infers afterwards as
    a fresh model loaded with its weights does, and a block alone infers
    from a state dict loaded after its first forward.  In bfloat16, where
    the memo holds copies (a float32 one may alias the parameter)."""
    bf16 = torch.bfloat16
    model = tyolo.YOLO(num_classes=1, family="v12", compute_dtype=bf16)
    ttrain.create_train_state(model, SIZE, seed=1, device="cpu")
    images = torch.from_numpy(_batch()["images"])
    before = model(images)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    state, _ = ttrain.fit(model, iter(lambda: batch, None), SIZE, 2, log_every=5, device="cpu",
                          state=ttrain.TrainState(model, ttrain.make_optimizer(model, total_steps=2)))
    fresh = tyolo.YOLO(num_classes=1, family="v12", compute_dtype=bf16)
    fresh.load_state_dict(model.state_dict())
    leaves = torch.utils._pytree.tree_leaves
    got, want, old = (leaves(out) for out in (model(images), fresh(images), before))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not all(torch.equal(g, o) for g, o in zip(got, old))
    block, other = (tyolo.A2C2f(32, 32, n=1, a2=True, area=1, dtype=bf16) for _ in range(2))
    x = torch.from_numpy(np.random.default_rng(3).random((1, 8, 8, 32)).astype(np.float32))
    block(x)
    block.load_state_dict(other.state_dict())
    assert torch.equal(block(x), other(x))


def test_fit_history_and_results_csv(tmp_path, capsys):
    """`fit` logs the first step and every ``log_every``-th, with the JAX
    package's line and keys; `write_results_csv` writes what the JAX
    function writes for that history."""
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    state, history = ttrain.fit(tyolo.YOLO(num_classes=1), iter(lambda: batch, None), SIZE, 3, log_every=2,
                                device="cpu")
    assert [h["step"] for h in history] == [1, 2] and state.step == 3 and not state.model.training
    assert set(history[0]) == {"step", "loss", "loss_box", "loss_cls", "loss_dfl", "num_fg", "grad_norm"}
    assert all(math.isfinite(v) for h in history for v in h.values())
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0].startswith("step 1/3: ") and "grad_norm=" in out[0]
    history.append({"step": 3, "loss": 1.5, "extra": 2.0})
    ttrain.write_results_csv(history, str(tmp_path / "port.csv"))
    jtrain.write_results_csv(history, str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    rows = list(csv.DictReader(io.StringIO((tmp_path / "port.csv").read_text())))
    assert list(rows[0])[0] == "step" and rows[2]["extra"] == "2.0" and rows[0]["extra"] == ""
