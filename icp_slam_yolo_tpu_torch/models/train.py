"""YOLO training: the optimizer chain, the initial weights, the train step,
a host loop and the results CSV; the counterpart of the JAX package's
``models/train.py``.

The recipe is Ultralytics' (SGD lr0 0.01, momentum 0.937, weight decay
5e-4, a warm-up and a cosine decay to lrf 0.01, batch 16, 640 px), as the
JAX package runs it through optax:
``clip_by_global_norm(10)``, then weight decay on every parameter but the
biases and BatchNorm scales, then Nesterov SGD on a warm-up + cosine
schedule.  Here the clip is done on the gradients before
``torch.optim.SGD(nesterov=True)``, which adds the decay (per parameter
group) and the momentum in optax's order, at the learning rate the
schedule gives for the update count before the step.

The step keeps everything on the device: its metrics are tensors, the
gradient norm included; `fit` reads them on the logged steps only.

Data-parallel training (``make_train_step(..., mesh=...)``, one process a
card): each rank takes its block of the global batch, its BatchNorm
statistics and loss normalisers are the global batch's
(`parallel.distributed.data_parallel`), and one all-reduce sums the
gradients in one flat buffer before the optimizer, so the clip sees the
global gradient and every rank applies the same update.  Not
``DistributedDataParallel``: it averages the gradients (wrong once the
normalisers are global) and broadcasts rank 0's buffers at each forward,
which would hide a divergence between the ranks; not ``SyncBatchNorm``: it
stores the unbiased variance.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from icp_slam_yolo_tpu_torch import convert
from icp_slam_yolo_tpu_torch.models.losses import LossWeights, detection_loss, pose_loss, segmentation_loss
from icp_slam_yolo_tpu_torch.models.yolo import YOLO, A2C2f, DetectHead
from icp_slam_yolo_tpu_torch.parallel import distributed
from icp_slam_yolo_tpu_torch.parallel.mesh import make_mesh, mesh_device, rank_block

TRUNC_STD = 0.87962566103423978  # the std of a standard normal cut at +-2 (flax's lecun_normal divides by it)


def lr_schedule(lr: float = 0.01, warmup_steps: int = 100, total_steps: int = 10000):
    """optax's ``warmup_cosine_decay_schedule(init=lr * 0.1, peak=lr,
    warmup=min(warmup_steps, max(total // 10, 1)), decay_steps=max(total,
    warmup + 1), end=lr * 0.01)`` as a function of the update count, in
    float32 as optax evaluates it."""
    f32 = np.float32
    warmup = min(warmup_steps, max(total_steps // 10, 1))
    decay = max(total_steps, warmup + 1) - warmup
    init, peak, end = lr * 0.1, lr, lr * 0.01
    alpha = end / peak

    def schedule(count: int) -> float:
        if count < warmup:  # linear from init to peak
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float(f32(init - peak) * frac + f32(peak))
        c = f32(min(count - warmup, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay), dtype=f32))
        return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def decay_mask(model: torch.nn.Module) -> dict[str, bool]:
    """optax's decay mask, by each parameter's flax leaf name
    (`convert.flax_leaves`): every parameter decays but the ``bias`` and
    ``scale`` leaves (conv and BatchNorm biases, BatchNorm scales)."""
    leaf = {key: path[-1] for key, path, _ in convert.flax_leaves(model) if path[0] == "params"}
    return {n: leaf[n] not in ("bias", "scale") for n, _ in model.named_parameters()}


class Optimizer:
    """optax's chain ``clip_by_global_norm(clip_norm)`` ->
    ``masked(add_decayed_weights(weight_decay))`` -> ``sgd(schedule,
    momentum, nesterov=True)`` over a model's parameters.  The clip is
    optax's formula (``g`` when ``|g| < clip_norm``, else ``g * clip_norm /
    |g|``: no epsilon), applied on the device without a host read."""

    def __init__(self, model: torch.nn.Module, lr: float = 0.01, momentum: float = 0.937,
                 weight_decay: float = 0.0005, warmup_steps: int = 100, total_steps: int = 10000,
                 clip_norm: float = 10.0):
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        decays = decay_mask(model)
        self.params = [p for _, p in named]
        self.clip_norm = clip_norm
        self.schedule = lr_schedule(lr, warmup_steps, total_steps)
        self.count = 0
        groups = [{"params": [p for n, p in named if decays[n]], "weight_decay": weight_decay},
                  {"params": [p for n, p in named if not decays[n]], "weight_decay": 0.0}]
        self.sgd = torch.optim.SGD([g for g in groups if g["params"]], lr=self.schedule(0), momentum=momentum,
                                   dampening=0.0, nesterov=True)

    def zero_grad(self):
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad`` (a parameter the loss
        did not reach takes a zero gradient, as in optax: it still decays);
        returns the global norm of the unclipped gradients (a device
        scalar)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(g_norm < self.clip_norm, torch.ones_like(g_norm), self.clip_norm / g_norm)
        torch._foreach_mul_(grads, scale)
        for group in self.sgd.param_groups:
            group["lr"] = self.schedule(self.count)
        self.sgd.step()
        self.count += 1
        return g_norm


make_optimizer = Optimizer  # the JAX package's name for the chain


@torch.no_grad()
def init_weights(model: YOLO, generator: torch.Generator) -> None:
    """flax's initial distributions, drawn from ``generator``: every conv
    kernel (depthwise too) truncated-normal ``lecun_normal`` (std
    ``sqrt(1 / fan_in) / 0.8796``, cut at 2 sigma), biases 0, BatchNorm
    scale 1, bias 0, mean 0 and variance 1; the class branches' biases -4.6
    (a prior of ~0.01) and the A2C2f residual scales 0.01."""
    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            w = mod.weight
            std = math.sqrt(1.0 / (w.shape[1] * w.shape[2] * w.shape[3])) / TRUNC_STD
            torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, torch.nn.BatchNorm2d):
            mod.reset_parameters()
        elif isinstance(mod, A2C2f) and mod.gamma is not None:
            mod.gamma.fill_(0.01)
    for mod in model.modules():
        if isinstance(mod, DetectHead):
            mod.reset_class_bias()


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), the optimizer
    (momentum buffers and update count) and the number of steps taken."""
    model: YOLO
    optimizer: Optimizer
    step: int = 0


def create_train_state(model: YOLO, img_size: int = 640, seed: int = 0, tx: Optimizer | None = None,
                       total_steps: int = 10000, device=None) -> TrainState:
    """Initial weights from ``torch.Generator().manual_seed(seed)`` (drawn
    on the CPU, then moved), the model on ``device`` (None: the card),
    the optimizer over its parameters.  ``img_size`` is the JAX signature's
    (flax needs an input to build the model; the port does not)."""
    from icp_slam_yolo_tpu_torch.device import resolve_device

    del img_size
    model.to("cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    model.to(resolve_device(device))
    return TrainState(model, tx or make_optimizer(model, total_steps=total_steps))


def compute_loss(model: YOLO, out, batch: dict, img_size: int, weights: LossWeights = LossWeights()):
    """The task's loss of a forward's output on a batch: detect (and obb,
    with ``angles``), segment (``masks``) or pose (``kpts``)."""
    if model.task == "segment":
        outs, protos = out
        return segmentation_loss(outs, protos, batch["boxes"], batch["classes"], batch["valid"], batch["masks"],
                                 img_size, model.num_classes, model.reg_max, weights)
    if model.task == "pose":
        return pose_loss(out, batch["boxes"], batch["classes"], batch["valid"], batch["kpts"], img_size,
                         model.num_classes, model.reg_max, weights)
    return detection_loss(out, batch["boxes"], batch["classes"], batch["valid"], img_size, model.num_classes,
                          model.reg_max, weights, gt_angles=batch.get("angles"))


def _sum_gradients(params: list, group) -> None:
    """Each parameter's ``.grad`` summed over the ranks of ``group``: one
    all-reduce of one flat buffer (a parameter the loss did not reach
    contributes zeros, as `Optimizer.step` would fill in)."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = distributed.all_sum_(torch.cat([g.reshape(-1) for g in grads]), group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p).to(p.dtype)


def _sum_metrics(metrics: dict, group) -> dict:
    """The ranks' shares of each metric summed (in float64, one all-reduce):
    the global batch's losses and ``num_fg``."""
    total = distributed.all_sum_(torch.stack([v.detach().to(torch.float64) for v in metrics.values()]), group)
    return {k: t.to(v.dtype) for (k, v), t in zip(metrics.items(), total)}


def make_train_step(model: YOLO, tx: Optimizer, img_size: int, weights: LossWeights = LossWeights(), mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)``: a training-mode
    forward, the loss, the gradients, one optimizer update.  ``batch``:
    ``images (B, S, S, 3)``, ``boxes (B, M, 4)`` xyxy pixels, ``classes (B,
    M)``, ``valid (B, M)`` and the task's ``angles``, ``masks`` or ``kpts``,
    on the model's device.  The metrics (the losses, ``num_fg`` and the
    unclipped gradients' ``grad_norm``) are device tensors.

    With a ``mesh``, ``batch`` is this rank's block of the global batch
    (`parallel.mesh.rank_block`), the step is the global batch's (module
    docstring) and the metrics are the global batch's on every rank."""
    group = None if mesh is None else mesh.get_group("data")

    def step(state: TrainState, batch: dict):
        model.train()
        tx.zero_grad()
        with distributed.data_parallel(group):
            out = model(batch["images"])
            total, metrics = compute_loss(model, out, batch, img_size, weights)
        total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if group is not None:
            _sum_gradients(tx.params, group)
            metrics = _sum_metrics(metrics, group)
        g_norm = tx.step()
        state.step += 1
        return state, {**metrics, "grad_norm": g_norm}

    return step


def fit(model: YOLO, dataset_iter, img_size: int, steps: int, state: TrainState | None = None,
        tx: Optimizer | None = None, log_every: int = 50, device=None):
    """A host training loop over an iterator of batches.  The host reads the
    metrics only on the logged steps (the first and every ``log_every``-th),
    and prints them there."""
    if state is None:
        state = create_train_state(model, img_size, total_steps=steps, tx=tx, device=device)
    step_fn = make_train_step(state.model, state.optimizer, img_size)
    history = []
    for i in range(steps):
        state, metrics = step_fn(state, next(dataset_iter))
        if (i + 1) % log_every == 0 or i == 0:
            m = {"step": i + 1, **{k: float(v) for k, v in metrics.items()}}
            history.append(m)
            print(f"step {i + 1}/{steps}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items() if k != "step"))
    state.model.eval()
    return state, history


def write_results_csv(history: list[dict], path: str) -> None:
    """The training curve as a CSV (Ultralytics writes a ``results.csv`` a
    run): one row a logged step, the columns the union over the history."""
    import csv

    cols = sorted({k for row in history for k in row}, key=lambda k: (k != "step", k))
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(history)


def dryrun_train_step(n_devices: int, img_size: int = 64, batch: int | None = None, device=None) -> dict:
    """One data-parallel train step over a mesh of ``n_devices`` ranks, on
    the JAX package's tiny shapes: a 1-class v8 detector from seed 0,
    ``batch`` (default ``n_devices``) uniform images and one 32 px box an
    image; each rank takes its block of the batch.  Needs an initialised
    process group of ``n_devices`` ranks (ValueError otherwise); every rank
    calls it.  Checks that the loss is finite and that the parameters after
    the step are equal on every rank (AssertionError otherwise); returns
    the step's metrics as floats.  ``device``: default the mesh's device on
    this rank."""
    if not torch.distributed.is_initialized() or distributed.process_count() != n_devices:
        raise ValueError(f"dryrun_train_step({n_devices}) needs an initialised process group of {n_devices} ranks, "
                         f"not {distributed.process_count()}")
    mesh = make_mesh(n_devices, device_type=None if device is None else torch.device(device).type)
    dev = mesh_device(mesh) if device is None else torch.device(device)
    b, m = batch or n_devices, 4
    model = YOLO(num_classes=1)
    state = create_train_state(model, img_size, total_steps=10, device=dev)
    rng = np.random.default_rng(0)
    full = {"images": rng.uniform(0, 1, (b, img_size, img_size, 3)).astype(np.float32),
            "boxes": np.tile(np.array([[8.0, 8, 40, 40]], np.float32), (b, m, 1)),
            "classes": np.zeros((b, m), np.int32),
            "valid": np.tile(np.array([True] + [False] * (m - 1)), (b, 1))}
    rows = rank_block(b, mesh)
    step = make_train_step(model, state.optimizer, img_size, mesh=mesh)
    state, metrics = step(state, {k: torch.from_numpy(v[rows]).to(dev) for k, v in full.items()})
    values = {k: float(v) for k, v in metrics.items()}
    if not math.isfinite(values["loss"]):
        raise AssertionError(f"dryrun_train_step: the loss is not finite ({values['loss']})")
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    every = distributed.all_concat(flat[None], mesh.get_group("data"))
    if not bool((every == every[:1]).all()):
        raise AssertionError("dryrun_train_step: the ranks' parameters differ after the step")
    return values
