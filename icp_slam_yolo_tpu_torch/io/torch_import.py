"""Ultralytics ``.pt`` weights -> the port's v8 `YOLO`; the counterpart of
the JAX package's ``io/torch_import.py``.

The reference fine-tunes from COCO-pretrained Ultralytics checkpoints.  This
maps an Ultralytics-layout flat state dict onto `models.yolo.YOLO`'s module
tree (``family="v8"``, ``task="detect"``, BatchNorm unfolded), so a
``.pt``-derived parameter set serves here.

Weight compatibility holds for the ``family="v8"`` graph only: backbone
(Conv/C2f/SPPF ladder), PAN-FPN neck and decoupled DFL head follow the
upstream yolov8 wiring block for block, including concat order and the
channel split inside C2f.  The v11/v12 graphs match the public yamls in
block counts but not parameter for parameter, so importing them is refused.

Both layouts are PyTorch's: conv weights stay OIHW, BatchNorm keeps
``weight``/``bias``/``running_mean``/``running_var``.  The head's DFL conv
is a frozen ``arange`` projection in Ultralytics and computed in the decode
here, so ``*.dfl.*`` keys are skipped.

Ultralytics module index -> this tree (yolov8 yaml order):
  0 stem, 1 down2, 2 c2f_2, 3 down3, 4 c2f_3, 5 down4, 6 c2f_4, 7 down5,
  8 c2f_5, 9 sppf, [10 Upsample, 11 Concat], 12 neck_p4, [13, 14],
  15 neck_p3, 16 pan_d3, [17], 18 pan_p4, 19 pan_d4, [20], 21 pan_p5,
  22 head (cv2 = box branch, cv3 = class branch, dfl skipped).

A real Ultralytics ``.pt`` pickles its module objects, and unpickling those
needs the ``ultralytics`` package; `load_ultralytics_pt` takes such a file
where that package is installed, and otherwise a ``.pt`` holding a plain
state dict of tensors (``torch.save(model.state_dict(), path)``), which is
what this repository's tests and smoke run write.
"""

from __future__ import annotations

import numpy as np
import torch

_BACKBONE_IDX = {
    "0": "stem", "1": "down2", "2": "c2f_2", "3": "down3", "4": "c2f_3",
    "5": "down4", "6": "c2f_4", "7": "down5", "8": "c2f_5", "9": "sppf",
    "12": "neck_p4", "15": "neck_p3", "16": "pan_d3", "18": "pan_p4",
    "19": "pan_d4", "21": "pan_p5", "22": "head",
}
_BN = ("weight", "bias", "running_mean", "running_var")


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v, np.float32))


def _convbn(out: dict, scope: str, prefix: str, sd: dict) -> None:
    """One ConvBnAct: ``<prefix>.conv`` + ``<prefix>.bn`` -> ``<scope>.conv`` +
    ``<scope>.bn``."""
    out[f"{scope}.conv.weight"] = _tensor(sd.pop(f"{prefix}.conv.weight"))
    for name in _BN:
        out[f"{scope}.bn.{name}"] = _tensor(sd.pop(f"{prefix}.bn.{name}"))
    sd.pop(f"{prefix}.bn.num_batches_tracked", None)


def _plain_conv(out: dict, scope: str, prefix: str, sd: dict) -> None:
    out[f"{scope}.conv.weight"] = _tensor(sd.pop(f"{prefix}.weight"))
    if f"{prefix}.bias" in sd:
        out[f"{scope}.conv.bias"] = _tensor(sd.pop(f"{prefix}.bias"))


def _c2f(out: dict, name: str, tp: str, sd: dict) -> None:
    """C2f: cv1 -> ConvBnAct_0, m.{i} -> Bottleneck_{i}, cv2 -> ConvBnAct_1."""
    _convbn(out, f"{name}.ConvBnAct_0", f"{tp}.cv1", sd)
    i = 0
    while f"{tp}.m.{i}.cv1.conv.weight" in sd:
        _convbn(out, f"{name}.Bottleneck_{i}.ConvBnAct_0", f"{tp}.m.{i}.cv1", sd)
        _convbn(out, f"{name}.Bottleneck_{i}.ConvBnAct_1", f"{tp}.m.{i}.cv2", sd)
        i += 1
    _convbn(out, f"{name}.ConvBnAct_1", f"{tp}.cv2", sd)


def _detect_head(out: dict, tp: str, sd: dict, n_levels: int = 3) -> None:
    """Decoupled head, per pyramid level i: box ConvBnAct_{4i},{4i+1} +
    Conv_{2i}; class ConvBnAct_{4i+2},{4i+3} + Conv_{2i+1}."""
    for i in range(n_levels):
        _convbn(out, f"head.ConvBnAct_{4 * i}", f"{tp}.cv2.{i}.0", sd)
        _convbn(out, f"head.ConvBnAct_{4 * i + 1}", f"{tp}.cv2.{i}.1", sd)
        _plain_conv(out, f"head.Conv_{2 * i}", f"{tp}.cv2.{i}.2", sd)
        _convbn(out, f"head.ConvBnAct_{4 * i + 2}", f"{tp}.cv3.{i}.0", sd)
        _convbn(out, f"head.ConvBnAct_{4 * i + 3}", f"{tp}.cv3.{i}.1", sd)
        _plain_conv(out, f"head.Conv_{2 * i + 1}", f"{tp}.cv3.{i}.2", sd)
    for k in [k for k in sd if k.startswith(f"{tp}.dfl.")]:
        sd.pop(k)  # the DFL projection is a frozen arange, computed in the decode


def convert_state_dict(state_dict: dict, family: str = "v8") -> dict:
    """Ultralytics flat state dict -> the ``state_dict`` of the port's
    ``YOLO(family="v8", task="detect", fold_bn=False)`` (float32 tensors).

    Values may be tensors or numpy arrays; keys may carry the
    DetectionModel's ``model.`` prefix or not.  Raises ``ValueError`` on
    non-v8 families (not weight-compatible) and on keys left unmapped."""
    if family != "v8":
        raise ValueError(
            f"family {family!r} is a capability port, not weight-compatible "
            "with Ultralytics layouts; only family='v8' can import .pt weights"
        )
    sd = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in state_dict.items()}
    out: dict = {}
    for tp, name in _BACKBONE_IDX.items():
        if name == "head":
            _detect_head(out, tp, sd)
        elif any(k.startswith(tp + ".cv1.") for k in sd):
            if any(k.startswith(tp + ".m.") for k in sd):
                _c2f(out, name, tp, sd)
            else:  # SPPF: cv1/cv2 only
                _convbn(out, f"{name}.ConvBnAct_0", f"{tp}.cv1", sd)
                _convbn(out, f"{name}.ConvBnAct_1", f"{tp}.cv2", sd)
        else:  # bare ConvBnAct (stem, downsamples)
            _convbn(out, name, tp, sd)
    if sd:
        raise ValueError(f"unmapped torch keys after import: {sorted(sd)[:8]} "
                         f"(+{max(0, len(sd) - 8)} more)")
    return out


def validate_against_model(state: dict, model) -> dict:
    """Shape-check an imported state dict against ``model`` (an unfolded
    `YOLO`): every parameter and statistic must be there with the same
    shape, and nothing else.  Returns the state with the model's own
    ``num_batches_tracked`` buffers added, ready for ``load_state_dict``."""
    own = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    missing, extra = sorted(set(own) - set(state)), sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"tree mismatch: missing {missing[:8]}, unexpected {extra[:8]}")
    for k, ref in own.items():
        if tuple(state[k].shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch at {k}: expected {tuple(ref.shape)}, got {tuple(state[k].shape)}")
    full = dict(model.state_dict())
    full.update(state)
    return full


def fold_state_dict(state: dict, eps: float) -> dict:
    """Absorb each ConvBnAct's BatchNorm into its conv, as
    `models.yolo.fold_batchnorm` does on a flax tree (the same float32
    arithmetic: ``s = scale / sqrt(var + eps)``, ``w' = w * s``, ``b' = bias
    - mean * s``).  Returns the state of ``YOLO(fold_bn=True)``."""
    out = {k: v for k, v in state.items() if ".bn." not in k}
    for key in [k for k in state if k.endswith(".bn.weight")]:
        scope = key[: -len(".bn.weight")]
        w, g, b, mean, var = (np.asarray(state[f"{scope}.{n}"], np.float32)
                              for n in ("conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var"))
        s = g / np.sqrt(var + np.float32(eps))
        out[f"{scope}.conv.weight"] = torch.from_numpy(w * s[:, None, None, None])
        out[f"{scope}.conv.bias"] = torch.from_numpy(b - mean * s)
    return out


def load_ultralytics_pt(path: str, num_classes: int = 1, variant: str = "n") -> dict:
    """Load a ``.pt`` holding an Ultralytics v8 detect model -> the state
    dict of the port's unfolded ``YOLO(num_classes, variant, family="v8")``.
    The file may hold a plain state dict, a model object with
    ``state_dict()``, or a dict with such a model under ``"model"`` (the
    last two need their classes importable: see the module docstring)."""
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO

    blob = torch.load(path, map_location="cpu", weights_only=False)
    model_obj = blob.get("model", blob) if isinstance(blob, dict) else blob
    sd = model_obj.state_dict() if hasattr(model_obj, "state_dict") else model_obj
    with torch.random.fork_rng(devices=[]):  # a fresh module for its shapes: leave the caller's generator alone
        fresh = YOLO(num_classes=num_classes, variant=variant, family="v8")
    return validate_against_model(convert_state_dict(sd), fresh)
