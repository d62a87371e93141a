"""Seeded detector weights in Ultralytics' state-dict layout, made on the
device in one draw per law.

Conv weights are normal with standard deviation ``gain / sqrt(fan_in)``,
each filter shifted to zero mean
(the head's two output convs with gains of their own, so that the class
logits spread about their prior and the box bins stay soft, as in a
trained model);
BatchNorm scales uniform in the configuration's ``bn_scale`` range, shifts normal with standard
deviation 0.1, running statistics those of a calibration batch; the
head's output biases are 0 for the box branch and the configuration's
``class_bias`` for the class branch (``log(p / (1 - p))`` of the prior
class probability).
"""

from __future__ import annotations

import torch

from portbench.reference.yolo import calibrate, state_layout


def ultralytics_state(cfg: dict, seed: int, device, frames: torch.Tensor | None = None) -> dict:
    """``{key: float32 tensor}`` for every tensor of the model's state dict;
    with ``frames`` (NHWC), the BatchNorm statistics are calibrated on them
    (`reference.yolo.calibrate`)."""
    layout = state_layout(cfg)
    init = cfg["init"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63 ^ 0x5DEECE66D)
    sizes = [torch.Size(s).numel() for _, s in layout]
    total = sum(sizes)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for (key, shape), n in zip(layout, sizes):
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if key.endswith(".weight") and len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            gain = init["gain"]
            if ".cv2." in key and key.endswith(".2.weight"):
                gain = init["box_out_gain"]
            elif ".cv3." in key and key.endswith(".2.weight"):
                gain = init["class_out_gain"]
            z = z - z.mean(dim=(1, 2, 3), keepdim=True)  # zero-mean filters, as trained ones nearly are
            out[key] = z * (gain / fan_in ** 0.5)
        elif key.endswith("bn.weight"):
            lo, hi = init["bn_scale"]
            out[key] = lo + (hi - lo) * u
        elif key.endswith("bn.running_var"):
            out[key] = 0.5 + 1.5 * u
        elif key.endswith("bn.bias") or key.endswith("bn.running_mean"):
            out[key] = 0.1 * z
        elif ".cv3." in key:  # class branch output bias
            out[key] = torch.full(shape, float(init["class_bias"]), device=device)
        else:
            out[key] = torch.zeros(shape, device=device)
    if frames is not None:
        out = calibrate(cfg, out, frames.permute(0, 3, 1, 2))
    return out
