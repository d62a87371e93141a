"""Carry SLAM state and detector weights between the JAX package and the port.

SLAM has no weights: its state (pose, map buffer, occupancy grid, previous
scan, counters) is what moves.  The field names are those of the JAX
``SlamState`` and of the ``.npz`` that its ``Slam.save_state`` writes.

The detector's weights are a flax tree (``params`` and ``batch_stats``, as
nested dicts of numpy arrays: what `io.checkpoint.load_checkpoint` reads);
`detector_params_from_numpy` turns it into the ``state_dict`` of the port's
`models.yolo.YOLO`.
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
    from icp_slam_yolo_tpu_torch.models.yolo import A2C2f, BatchNorm, Conv1x1, ConvBnAct, DepthwiseConv3x3

    flat = {**_flatten(params, ("params",)), **_flatten(batch_stats, ("batch_stats",))}
    used, state = set(), {}

    def take(*path):
        if path not in flat:
            raise KeyError(f"the flax tree has no leaf {'/'.join(path)}")
        used.add(path)
        return torch.from_numpy(np.array(flat[path], dtype=np.float32))

    for name, mod in model.named_modules():
        scope = tuple(name.split(".")) if name else ()  # () for the model itself (a block converted alone)
        pre = f"{name}." if name else ""
        if isinstance(mod, ConvBnAct):
            state[f"{pre}conv.weight"] = take("params", *scope, "Conv_0", "kernel").permute(3, 2, 0, 1).contiguous()
            if mod.folded:
                state[f"{pre}conv.bias"] = take("params", *scope, "Conv_0", "bias")
            else:
                state[f"{pre}bn.weight"] = take("params", *scope, "BatchNorm_0", "scale")
                state[f"{pre}bn.bias"] = take("params", *scope, "BatchNorm_0", "bias")
                state[f"{pre}bn.running_mean"] = take("batch_stats", *scope, "BatchNorm_0", "mean")
                state[f"{pre}bn.running_var"] = take("batch_stats", *scope, "BatchNorm_0", "var")
        elif isinstance(mod, (Conv1x1, DepthwiseConv3x3)):
            state[f"{pre}conv.weight"] = take("params", *scope, "kernel").permute(3, 2, 0, 1).contiguous()
            if mod.conv.bias is not None:
                state[f"{pre}conv.bias"] = take("params", *scope, "bias")
        elif isinstance(mod, BatchNorm):
            state[f"{pre}weight"] = take("params", *scope, "scale")
            state[f"{pre}bias"] = take("params", *scope, "bias")
            state[f"{pre}running_mean"] = take("batch_stats", *scope, "mean")
            state[f"{pre}running_var"] = take("batch_stats", *scope, "var")
        elif isinstance(mod, A2C2f) and mod.gamma is not None:
            state[f"{pre}gamma"] = take("params", *scope, "gamma")
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
