"""Carry SLAM state and detector weights between the JAX package and the port.

SLAM has no weights: its state (pose, map buffer, occupancy grid, previous
scan, counters) is what moves.  The field names are those of the JAX
``SlamState`` and of the ``.npz`` that its ``Slam.save_state`` writes.

The detector's weights are a flax tree (``params`` and ``batch_stats``, as
nested dicts of numpy arrays: what `io.checkpoint.load_checkpoint` reads);
`detector_params_from_numpy` turns it into the ``state_dict`` of the port's
`models.yolo.YOLO`, and `detector_params_to_numpy` back.
"""

from __future__ import annotations

import numpy as np
import torch

from icp_slam_yolo_tpu_torch.slam.pipeline import SlamState

_DTYPES = {
    "pose": torch.float32, "prev_pose": torch.float32, "map_xy": torch.float32,
    "map_valid": torch.bool, "occ": torch.float32, "prev_xy": torch.float32,
    "prev_valid": torch.bool, "step": torch.int32, "maint_count": torch.int32,
    "reject_run": torch.int32,
}


def state_from_numpy(arrays, device) -> SlamState:
    """A mapping of numpy arrays (a JAX ``SlamState._asdict()`` or a loaded
    ``.npz``; one robot's, or a fleet's with a leading robot axis on every
    field) -> the port's state on ``device``.  States saved before the
    motion-model and reseed fields default them as the JAX loader does."""
    fields = {k: np.asarray(arrays[k]) for k in arrays.keys()}
    fields.setdefault("prev_pose", fields["pose"])
    fields.setdefault("reject_run", np.int32(0))
    return SlamState(**{
        name: torch.as_tensor(np.array(fields[name]), dtype=dt, device=device)
        for name, dt in _DTYPES.items()
    })


def state_to_numpy(state: SlamState) -> dict:
    """The port's state -> a dict of numpy arrays with the JAX field names."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def _flatten(tree, prefix: tuple) -> dict:
    out = {}
    for key, sub in (tree or {}).items():
        if isinstance(sub, dict):
            out.update(_flatten(sub, prefix + (key,)))
        else:
            out[prefix + (key,)] = sub
    return out


def flax_leaves(model):
    """``(state_dict key, flax path, is_kernel)`` for every leaf of the
    model's flax tree, by the rule `detector_params_from_numpy` states: the
    path is ``("params" | "batch_stats", scope ..., leaf name)``; a kernel
    is HWIO in the tree and OIHW in the model."""
    from icp_slam_yolo_tpu_torch.models.yolo import A2C2f, BatchNorm, Conv1x1, ConvBnAct, DepthwiseConv3x3

    for name, mod in model.named_modules():
        scope = tuple(name.split(".")) if name else ()  # () for the model itself (a block converted alone)
        pre = f"{name}." if name else ""
        if isinstance(mod, ConvBnAct):
            yield f"{pre}conv.weight", ("params", *scope, "Conv_0", "kernel"), True
            if mod.folded:
                yield f"{pre}conv.bias", ("params", *scope, "Conv_0", "bias"), False
            else:
                yield f"{pre}bn.weight", ("params", *scope, "BatchNorm_0", "scale"), False
                yield f"{pre}bn.bias", ("params", *scope, "BatchNorm_0", "bias"), False
                yield f"{pre}bn.running_mean", ("batch_stats", *scope, "BatchNorm_0", "mean"), False
                yield f"{pre}bn.running_var", ("batch_stats", *scope, "BatchNorm_0", "var"), False
        elif isinstance(mod, (Conv1x1, DepthwiseConv3x3)):
            yield f"{pre}conv.weight", ("params", *scope, "kernel"), True
            if mod.conv.bias is not None:
                yield f"{pre}conv.bias", ("params", *scope, "bias"), False
        elif isinstance(mod, BatchNorm):
            yield f"{pre}weight", ("params", *scope, "scale"), False
            yield f"{pre}bias", ("params", *scope, "bias"), False
            yield f"{pre}running_mean", ("batch_stats", *scope, "mean"), False
            yield f"{pre}running_var", ("batch_stats", *scope, "var"), False
        elif isinstance(mod, A2C2f) and mod.gamma is not None:
            yield f"{pre}gamma", ("params", *scope, "gamma"), False


def detector_params_from_numpy(params: dict, batch_stats: dict, model) -> dict:
    """A flax tree of the JAX ``YOLO`` (folded or not, matching ``model``) ->
    the ``state_dict`` of the port's ``model``.

    The port's modules carry flax's scope names, so the map is by rule: a
    ``ConvBnAct`` scope ``s`` gives ``s/Conv_0/kernel`` (HWIO) ->
    ``s.conv.weight`` (OIHW), ``s/Conv_0/bias`` -> ``s.conv.bias`` when
    folded, else ``s/BatchNorm_0/{scale,bias}`` -> ``s.bn.{weight,bias}`` and
    the batch statistics ``mean``, ``var`` -> ``s.bn.running_{mean,var}``; a
    plain conv scope gives ``kernel`` and, where the conv has one, ``bias``
    (a 1x1, or the attention's depthwise 3x3, whose ``(3, 3, 1, c)`` kernel
    becomes ``(c, 1, 3, 3)`` by the same permutation); a bare BatchNorm
    scope (in a PSABlock or an ABlock: it does not fold) gives ``scale``,
    ``bias`` and the statistics ``mean``, ``var``; an A2C2f with a residual
    scale gives ``gamma``.  Raises on a leaf of the tree that no module
    consumed and on a module parameter that no leaf filled."""
    flat = {**_flatten(params, ("params",)), **_flatten(batch_stats, ("batch_stats",))}
    used, state = set(), {}
    for key, path, kernel in flax_leaves(model):
        if path not in flat:
            raise KeyError(f"the flax tree has no leaf {'/'.join(path)}")
        used.add(path)
        t = torch.from_numpy(np.array(flat[path], dtype=np.float32))
        state[key] = t.permute(3, 2, 0, 1).contiguous() if kernel else t
    unused = sorted("/".join(p) for p in set(flat) - used)
    if unused:
        raise ValueError(f"{len(unused)} leaves of the flax tree were not consumed, e.g. {unused[:4]}")
    own = model.state_dict()
    missing = sorted(k for k in own if k not in state and not k.endswith("num_batches_tracked"))
    if missing:
        raise ValueError(f"{len(missing)} parameters of the model were not filled, e.g. {missing[:4]}")
    for key, value in own.items():
        if key not in state:
            state[key] = value  # BatchNorm's num_batches_tracked: unused at inference
        elif state[key].shape != value.shape:
            raise ValueError(f"{key}: the tree gives {tuple(state[key].shape)}, the model has {tuple(value.shape)}")
    return state


def detector_params_to_numpy(model) -> tuple[dict, dict]:
    """The inverse of `detector_params_from_numpy`: the port's ``model`` ->
    ``(params, batch_stats)``, flax trees (nested dicts, flax's scope
    names) of float32 numpy arrays, kernels HWIO; what
    `io.checkpoint.save_checkpoint` writes and flax reads."""
    state = model.state_dict()
    trees = {"params": {}, "batch_stats": {}}
    for key, path, kernel in flax_leaves(model):
        t = state[key].detach().to("cpu", torch.float32)
        node = trees[path[0]]
        for part in path[1:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.array((t.permute(2, 3, 1, 0) if kernel else t).contiguous().numpy())  # a copy
    return trees["params"], trees["batch_stats"]
