"""Ultralytics ``.pt`` weights -> the port's v8 or YOLO12 `YOLO`; for v8
the counterpart of the JAX package's ``io/torch_import.py``.

The reference fine-tunes from COCO-pretrained Ultralytics checkpoints.  This
maps an Ultralytics-layout flat state dict onto `models.yolo.YOLO`'s module
tree (``task="detect"``, BatchNorm unfolded), so a ``.pt``-derived parameter
set serves here.

Weight compatibility holds for two graphs.  ``family="v8"``: backbone
(Conv/C2f/SPPF ladder), PAN-FPN neck and decoupled DFL head follow the
upstream yolov8 wiring block for block, including concat order and the
channel split inside C2f.  ``family="yolo12"``: the published YOLO12
(``yolo12.yaml``, scales n/s/m/l/x, ``Detect`` with ``legacy=False``),
``A2C2f``'s head-grouped ``qkv`` and ``gamma`` included.  The port's own
``v11``/``v12`` graphs match the public yamls in block counts but not
parameter for parameter, so importing them is refused (YOLO12 weights load
with ``family="yolo12"``, which `load_ultralytics_pt` reads from the keys).

Both layouts are PyTorch's: conv weights stay OIHW, BatchNorm keeps
``weight``/``bias``/``running_mean``/``running_var``.  The head's DFL conv
is a frozen ``arange`` projection in Ultralytics and computed in the decode
here, so ``*.dfl.*`` keys are skipped.

Ultralytics module index -> this tree (yolov8 yaml order):
  0 stem, 1 down2, 2 c2f_2, 3 down3, 4 c2f_3, 5 down4, 6 c2f_4, 7 down5,
  8 c2f_5, 9 sppf, [10 Upsample, 11 Concat], 12 neck_p4, [13, 14],
  15 neck_p3, 16 pan_d3, [17], 18 pan_p4, 19 pan_d4, [20], 21 pan_p5,
  22 head (cv2 = box branch, cv3 = class branch, dfl skipped).
(yolo12 yaml order):
  0 stem, 1 down2, 2 b2, 3 down3, 4 b3, 5 down4, 6 b4, 7 down5, 8 b5,
  [9, 10], 11 neck_p4, [12, 13], 14 neck_p3, 15 pan_d3, [16], 17 pan_p4,
  18 pan_d4, [19], 20 pan_p5, 21 head.  ``C3k2``/``C3k``/``Bottleneck``
  children take the port's names (``cv1`` -> ``ConvBnAct_0`` ...), the
  ``A2C2f`` blocks keep Ultralytics' (``cv1``, ``m.<j>.<b>.attn.qkv``,
  ``mlp.0``, ``gamma``); the head's level ``i``: ``cv2.i.0/1`` ->
  ``ConvBnAct_{6i}/{6i+1}``, ``cv2.i.2`` -> ``Conv_{2i}``, ``cv3.i.0.0``,
  ``cv3.i.0.1``, ``cv3.i.1.0``, ``cv3.i.1.1`` -> ``ConvBnAct_{6i+2..6i+5}``,
  ``cv3.i.2`` -> ``Conv_{2i+1}``.

A real Ultralytics ``.pt`` pickles its module objects, and unpickling those
needs the ``ultralytics`` package; `load_ultralytics_pt` takes such a file
where that package is installed, and otherwise a ``.pt`` holding a plain
state dict of tensors (``torch.save(model.state_dict(), path)``), which is
what this repository's tests and smoke run write.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BACKBONE_IDX = {
    "0": "stem", "1": "down2", "2": "c2f_2", "3": "down3", "4": "c2f_3",
    "5": "down4", "6": "c2f_4", "7": "down5", "8": "c2f_5", "9": "sppf",
    "12": "neck_p4", "15": "neck_p3", "16": "pan_d3", "18": "pan_p4",
    "19": "pan_d4", "21": "pan_p5", "22": "head",
}
_YOLO12_IDX = {
    "0": "stem", "1": "down2", "2": "b2", "3": "down3", "4": "b3", "5": "down4", "6": "b4", "7": "down5",
    "8": "b5", "11": "neck_p4", "14": "neck_p3", "15": "pan_d3", "17": "pan_p4", "18": "pan_d4",
    "20": "pan_p5", "21": "head",
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


def _has(sd: dict, prefix: str) -> bool:
    return any(k.startswith(prefix) for k in sd)


def _bottleneck(out: dict, name: str, tp: str, sd: dict) -> None:
    _convbn(out, f"{name}.ConvBnAct_0", f"{tp}.cv1", sd)
    _convbn(out, f"{name}.ConvBnAct_1", f"{tp}.cv2", sd)


def _c3k(out: dict, name: str, tp: str, sd: dict) -> None:
    """C3k: cv1, cv2 -> ConvBnAct_0, _1; m.{j} -> Bottleneck_{j}; cv3 -> ConvBnAct_2."""
    _convbn(out, f"{name}.ConvBnAct_0", f"{tp}.cv1", sd)
    _convbn(out, f"{name}.ConvBnAct_1", f"{tp}.cv2", sd)
    j = 0
    while _has(sd, f"{tp}.m.{j}."):
        _bottleneck(out, f"{name}.Bottleneck_{j}", f"{tp}.m.{j}", sd)
        j += 1
    _convbn(out, f"{name}.ConvBnAct_2", f"{tp}.cv3", sd)


def _c3k2(out: dict, name: str, tp: str, sd: dict) -> None:
    """C3k2: cv1 -> ConvBnAct_0; m.{j} -> C3k_{j} (a C3k, with a cv3) or
    Bottleneck_{j}; cv2 -> ConvBnAct_1."""
    _convbn(out, f"{name}.ConvBnAct_0", f"{tp}.cv1", sd)
    j = 0
    while _has(sd, f"{tp}.m.{j}."):
        if f"{tp}.m.{j}.cv3.conv.weight" in sd:
            _c3k(out, f"{name}.C3k_{j}", f"{tp}.m.{j}", sd)
        else:
            _bottleneck(out, f"{name}.Bottleneck_{j}", f"{tp}.m.{j}", sd)
        j += 1
    _convbn(out, f"{name}.ConvBnAct_1", f"{tp}.cv2", sd)


def _a2c2f(out: dict, name: str, tp: str, sd: dict) -> None:
    """A2C2f: Ultralytics' names, but a C3k module's children."""
    _convbn(out, f"{name}.cv1", f"{tp}.cv1", sd)
    j = 0
    while _has(sd, f"{tp}.m.{j}."):
        if _has(sd, f"{tp}.m.{j}.0.attn."):
            b = 0
            while _has(sd, f"{tp}.m.{j}.{b}."):
                for part in ("attn.qkv", "attn.proj", "attn.pe", "mlp.0", "mlp.1"):
                    _convbn(out, f"{name}.m.{j}.{b}.{part}", f"{tp}.m.{j}.{b}.{part}", sd)
                b += 1
        else:
            _c3k(out, f"{name}.m.{j}", f"{tp}.m.{j}", sd)
        j += 1
    _convbn(out, f"{name}.cv2", f"{tp}.cv2", sd)
    if f"{tp}.gamma" in sd:
        out[f"{name}.gamma"] = _tensor(sd.pop(f"{tp}.gamma"))


def _detect_head12(out: dict, tp: str, sd: dict, n_levels: int = 3) -> None:
    """The legacy-off head (see the module docstring for the numbering)."""
    for i in range(n_levels):
        _convbn(out, f"head.ConvBnAct_{6 * i}", f"{tp}.cv2.{i}.0", sd)
        _convbn(out, f"head.ConvBnAct_{6 * i + 1}", f"{tp}.cv2.{i}.1", sd)
        _plain_conv(out, f"head.Conv_{2 * i}", f"{tp}.cv2.{i}.2", sd)
        for n, part in enumerate(("0.0", "0.1", "1.0", "1.1")):
            _convbn(out, f"head.ConvBnAct_{6 * i + 2 + n}", f"{tp}.cv3.{i}.{part}", sd)
        _plain_conv(out, f"head.Conv_{2 * i + 1}", f"{tp}.cv3.{i}.2", sd)
    for k in [k for k in sd if k.startswith(f"{tp}.dfl.")]:
        sd.pop(k)


def _v8(sd: dict) -> dict:
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
    return out


def _yolo12(sd: dict) -> dict:
    out: dict = {}
    for tp, name in _YOLO12_IDX.items():
        if name == "head":
            _detect_head12(out, tp, sd)
        elif name in ("b2", "b3", "pan_p5"):
            _c3k2(out, name, tp, sd)
        elif name in ("b4", "b5", "neck_p4", "neck_p3", "pan_p4"):
            _a2c2f(out, name, tp, sd)
        else:
            _convbn(out, name, tp, sd)
    return out


def convert_state_dict(state_dict: dict, family: str = "v8") -> dict:
    """Ultralytics flat state dict -> the ``state_dict`` of the port's
    ``YOLO(family=family, task="detect", fold_bn=False)`` (float32 tensors),
    ``family`` "v8" or "yolo12".

    Values may be tensors or numpy arrays; keys may carry the
    DetectionModel's ``model.`` prefix or not.  Raises ``ValueError`` on
    other families (not weight-compatible) and on keys left unmapped."""
    if family not in ("v8", "yolo12"):
        raise ValueError(
            f"family {family!r} is a capability port, not weight-compatible "
            "with Ultralytics layouts; only family='v8' and family='yolo12' (the published YOLO12) "
            "can import .pt weights"
        )
    sd = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in state_dict.items()}
    out = _yolo12(sd) if family == "yolo12" else _v8(sd)
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


def yolo12_scale(state: dict) -> tuple[str, int]:
    """``(variant, num_classes)`` of a converted yolo12 state: the class count
    from the head's last conv, the variant the one whose tree has the same
    shapes (built on the meta device, no weights made)."""
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO, YOLO12_SCALES

    def shapes(sd):
        return {k: tuple(v.shape) for k, v in sd.items() if not k.endswith("num_batches_tracked")}

    nc = int(state["head.Conv_1.conv.bias"].shape[0])
    for variant in YOLO12_SCALES:
        with torch.device("meta"):
            own = YOLO(num_classes=nc, variant=variant, family="yolo12").state_dict()
        if shapes(own) == shapes(state):
            return variant, nc
    raise ValueError("the state dict matches no YOLO12 scale (n/s/m/l/x)")


def ultralytics_family(state_dict: dict) -> str:
    """``"yolo12"`` for a YOLO12 detect state dict (its ``A2C2f`` blocks'
    ``attn.qkv`` and its head's depthwise class branch ``cv3.<i>.0.0``),
    ``"v8"`` otherwise."""
    keys = list(state_dict)
    if any(".attn.qkv." in k for k in keys) or any(re.search(r"\.cv3\.\d+\.0\.0\.", k) for k in keys):
        return "yolo12"
    return "v8"


def load_ultralytics_pt(path: str, num_classes: int = 1, variant: str = "n") -> tuple[dict, dict]:
    """Load a ``.pt`` holding an Ultralytics detect model -> ``(state,
    meta)``: the state dict of the port's unfolded ``YOLO`` and its
    ``{"family", "variant", "num_classes"}``.  The family is read from the
    keys (`ultralytics_family`); for yolo12 the scale and the class count
    are read from the shapes (`yolo12_scale`), for v8 they are
    ``variant``/``num_classes``.  The file may hold a plain state dict, a
    model object with ``state_dict()``, or a dict with such a model under
    ``"model"`` (the last two need their classes importable: see the module
    docstring)."""
    from icp_slam_yolo_tpu_torch.models.yolo import YOLO

    blob = torch.load(path, map_location="cpu", weights_only=False)
    model_obj = blob.get("model", blob) if isinstance(blob, dict) else blob
    sd = model_obj.state_dict() if hasattr(model_obj, "state_dict") else model_obj
    family = ultralytics_family(sd)
    state = convert_state_dict(sd, family)
    if family == "yolo12":
        variant, num_classes = yolo12_scale(state)
    with torch.random.fork_rng(devices=[]):  # a fresh module for its shapes: leave the caller's generator alone
        fresh = YOLO(num_classes=num_classes, variant=variant, family=family)
    return validate_against_model(state, fresh), {"family": family, "variant": variant, "num_classes": num_classes}
