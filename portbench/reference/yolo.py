"""Plain YOLOv8 detect model, decode and NMS, over an Ultralytics-layout
state dict (``model.<i>.…`` keys, BatchNorm unfolded).

Written from the published ``yolov8.yaml`` (backbone of Conv / C2f / SPPF,
PAN-FPN neck, decoupled head with DFL box regression) and Ultralytics'
block definitions: ``Conv`` is conv (no bias) + BatchNorm + SiLU; ``C2f``
splits ``cv1``'s output in two, chains its bottlenecks on the second half
and concatenates every part into ``cv2``; ``SPPF`` chains three 5 x 5 max
pools.  The decode takes the DFL expectation over ``reg_max`` bins as
distances from the grid-cell centres, times the level's stride; the
detections are the configuration's: the ``max_detections`` anchors of
highest class confidence, kept if over ``conf_threshold``, then greedy
class-aware suppression at ``iou_threshold``.

``fp8=True`` is the check's control: every conv's input and weight are
rounded to float8 e4m3 with a per-tensor scale before a float32 conv.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

STRIDES = (8, 16, 32)
E4M3_MAX = 448.0


def _divisible(x: float, div: int = 8) -> int:
    return int(math.ceil(x / div) * div)


def widths(cfg: dict) -> list[int]:
    """The five stage widths: ``min(c, max_channels) * width`` rounded up to 8."""
    return [_divisible(min(c, cfg["max_channels"]) * cfg["width_multiple"]) for c in (64, 128, 256, 512, 1024)]


def repeats(cfg: dict, n: int) -> int:
    return max(round(n * cfg["depth_multiple"]), 1)


def architecture(cfg: dict) -> list[tuple]:
    """``yolov8.yaml`` scaled: per layer ``(index, kind, args)``; ``kind`` is
    conv (cin, cout, k, s), c2f (cin, cout, n, shortcut), sppf (cin, cout),
    up, cat (sources), detect (input widths)."""
    c = widths(cfg)
    n3, n6 = repeats(cfg, 3), repeats(cfg, 6)
    return [
        (0, "conv", (3, c[0], 3, 2)), (1, "conv", (c[0], c[1], 3, 2)), (2, "c2f", (c[1], c[1], n3, True)),
        (3, "conv", (c[1], c[2], 3, 2)), (4, "c2f", (c[2], c[2], n6, True)), (5, "conv", (c[2], c[3], 3, 2)),
        (6, "c2f", (c[3], c[3], n6, True)), (7, "conv", (c[3], c[4], 3, 2)), (8, "c2f", (c[4], c[4], n3, True)),
        (9, "sppf", (c[4], c[4])),
        (10, "up", ()), (11, "cat", (10, 6)), (12, "c2f", (c[4] + c[3], c[3], n3, False)),
        (13, "up", ()), (14, "cat", (13, 4)), (15, "c2f", (c[3] + c[2], c[2], n3, False)),
        (16, "conv", (c[2], c[2], 3, 2)), (17, "cat", (16, 12)), (18, "c2f", (c[2] + c[3], c[3], n3, False)),
        (19, "conv", (c[3], c[3], 3, 2)), (20, "cat", (19, 9)), (21, "c2f", (c[3] + c[4], c[4], n3, False)),
        (22, "detect", (c[2], c[3], c[4])),
    ]


def head_widths(cfg: dict) -> tuple[int, int]:
    """Box and class branch widths of Ultralytics' ``Detect``."""
    c = widths(cfg)
    return max(16, c[2] // 4, cfg["reg_max"] * 4), max(c[2], min(cfg["num_classes"], 100))


def conv_sites(cfg: dict) -> list[tuple[str, int, int, int, int, str]]:
    """Every conv of the model: ``(key prefix, cin, cout, k, stride, block)``
    with ``block`` the C2f it belongs to ('' outside one); ``*.2`` of the
    head are the biased 1 x 1 output convs."""
    out = []
    for i, kind, a in architecture(cfg):
        p = f"model.{i}"
        if kind == "conv":
            out.append((p, a[0], a[1], a[2], a[3], ""))
        elif kind == "c2f":
            cin, cout, n, _ = a
            h = cout // 2
            out.append((f"{p}.cv1", cin, 2 * h, 1, 1, p))
            for j in range(n):
                out += [(f"{p}.m.{j}.cv1", h, h, 3, 1, p), (f"{p}.m.{j}.cv2", h, h, 3, 1, p)]
            out.append((f"{p}.cv2", (2 + n) * h, cout, 1, 1, p))
        elif kind == "sppf":
            h = a[0] // 2
            out += [(f"{p}.cv1", a[0], h, 1, 1, ""), (f"{p}.cv2", 4 * h, a[1], 1, 1, "")]
        elif kind == "detect":
            c2, c3 = head_widths(cfg)
            for lvl, f in enumerate(a):
                out += [(f"{p}.cv2.{lvl}.0", f, c2, 3, 1, ""), (f"{p}.cv2.{lvl}.1", c2, c2, 3, 1, ""),
                        (f"{p}.cv2.{lvl}.2", c2, 4 * cfg["reg_max"], 1, 1, ""),
                        (f"{p}.cv3.{lvl}.0", f, c3, 3, 1, ""), (f"{p}.cv3.{lvl}.1", c3, c3, 3, 1, ""),
                        (f"{p}.cv3.{lvl}.2", c3, cfg["num_classes"], 1, 1, "")]
    return out


def state_layout(cfg: dict) -> list[tuple[str, tuple]]:
    """Every tensor of the Ultralytics state dict: ``(key, shape)``."""
    out = []
    for p, cin, cout, k, _, _ in conv_sites(cfg):
        if p.startswith(f"model.{architecture(cfg)[-1][0]}.") and p.endswith(".2"):
            out += [(f"{p}.weight", (cout, cin, k, k)), (f"{p}.bias", (cout,))]
        else:
            out.append((f"{p}.conv.weight", (cout, cin, k, k)))
            out += [(f"{p}.bn.{n}", (cout,)) for n in ("weight", "bias", "running_mean", "running_var")]
    return out


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(t.abs().amax(), min=1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Model:
    """The forward over a state dict (tensors on the model's device)."""

    def __init__(self, cfg: dict, sd: dict, fp8: bool = False):
        self.cfg, self.fp8 = cfg, fp8
        self.sd = {k: v.to(torch.float32) for k, v in sd.items()}
        self.calibrating = False

    def _conv2d(self, x, w, b, stride):
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        return F.conv2d(x, w, b, stride, w.shape[-1] // 2)

    def conv(self, x, p, stride=1):
        sd = self.sd
        y = self._conv2d(x, sd[f"{p}.conv.weight"], None, stride)
        if self.calibrating:
            sd[f"{p}.bn.running_mean"] = y.mean((0, 2, 3))
            sd[f"{p}.bn.running_var"] = y.var((0, 2, 3), unbiased=False)
        y = F.batch_norm(y, sd[f"{p}.bn.running_mean"], sd[f"{p}.bn.running_var"], sd[f"{p}.bn.weight"],
                         sd[f"{p}.bn.bias"], False, 0.0, self.cfg["bn_eps"])
        return F.silu(y)

    def c2f(self, x, p, n, shortcut):
        y = list(self.conv(x, f"{p}.cv1").chunk(2, 1))
        for j in range(n):
            z = self.conv(self.conv(y[-1], f"{p}.m.{j}.cv1"), f"{p}.m.{j}.cv2")
            y.append(y[-1] + z if shortcut else z)
        return self.conv(torch.cat(y, 1), f"{p}.cv2")

    def sppf(self, x, p):
        y = [self.conv(x, f"{p}.cv1")]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], 5, 1, 2))
        return self.conv(torch.cat(y, 1), f"{p}.cv2")

    def forward(self, images: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """``(B, 3, H, W)`` float in [0, 1] -> per level ``(box logits (B,
        4 reg_max, h, w), class logits (B, nc, h, w))``."""
        outs = {}
        x = images.to(torch.float32)
        for i, kind, a in architecture(self.cfg):
            p = f"model.{i}"
            if kind == "conv":
                x = self.conv(x, p, a[3])
            elif kind == "c2f":
                x = self.c2f(x, p, a[2], a[3])
            elif kind == "sppf":
                x = self.sppf(x, p)
            elif kind == "up":
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            elif kind == "cat":
                x = torch.cat([outs[j] for j in a], 1)
            else:
                levels = []
                for lvl, src in enumerate((15, 18, 21)):
                    f = outs[src]
                    br = []
                    for cv in ("cv2", "cv3"):
                        z = self.conv(self.conv(f, f"{p}.{cv}.{lvl}.0"), f"{p}.{cv}.{lvl}.1")
                        br.append(self._conv2d(z, self.sd[f"{p}.{cv}.{lvl}.2.weight"],
                                               self.sd[f"{p}.{cv}.{lvl}.2.bias"], 1))
                    levels.append(tuple(br))
                return levels
            outs[i] = x
        raise AssertionError("no detect layer")


def calibrate(cfg: dict, sd: dict, images: torch.Tensor) -> dict:
    """``sd`` with every BatchNorm's running statistics set to those of its
    conv's output over ``images`` (NCHW), layer after layer in one forward,
    as training leaves them: each conv's output then comes out normalised."""
    model = Model(cfg, sd)
    model.calibrating = True
    with torch.no_grad():
        model.forward(images)
    return {k: model.sd[k].to(v.dtype) for k, v in sd.items()}


def anchors(img_size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    pts, strides = [], []
    for s in STRIDES:
        n = img_size // s
        c = torch.arange(n, dtype=torch.float32, device=device) + 0.5
        yy, xx = torch.meshgrid(c, c, indexing="ij")
        pts.append(torch.stack([xx, yy], -1).reshape(-1, 2) * s)
        strides.append(torch.full((n * n,), float(s), device=device))
    return torch.cat(pts), torch.cat(strides)


def decode(levels, img_size: int, reg_max: int):
    """Per-anchor ``(boxes xyxy (B, A, 4), confidence (B, A), class (B, A))``."""
    box = torch.cat([b.flatten(2) for b, _ in levels], 2)  # (B, 4 reg_max, A)
    cls = torch.cat([c.flatten(2) for _, c in levels], 2)
    b, _, a = box.shape
    prob = torch.softmax(box.reshape(b, 4, reg_max, a).float(), dim=2)
    dist = (prob * torch.arange(reg_max, dtype=torch.float32, device=box.device)[None, None, :, None]).sum(2)
    anc, stride = anchors(img_size, box.device)
    lt, rb = dist[:, :2].transpose(1, 2), dist[:, 2:].transpose(1, 2)
    boxes = torch.cat([anc - lt * stride[:, None], anc + rb * stride[:, None]], -1)
    conf, label = torch.sigmoid(cls.float()).max(1)
    return boxes, conf, label


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(x[:, 3] - x[:, 1], 0, None)  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-9)


def detections(boxes, conf, label, cfg: dict) -> list[dict]:
    """Per image: the configuration's top-k, threshold and greedy
    class-aware suppression; ``{"boxes", "scores", "classes", "anchors"}``
    numpy, in score order."""
    out = []
    k = min(cfg["max_detections"], conf.shape[1])
    for bx, cf, lb in zip(boxes.double().cpu().numpy(), conf.double().cpu().numpy(), label.cpu().numpy()):
        order = np.argsort(-cf, kind="stable")[:k]
        bx, cf, lb = bx[order], cf[order], lb[order]
        iou = _iou(bx, bx)
        kept = []
        for i in range(k):
            if cf[i] < cfg["conf_threshold"]:
                continue
            if any(lb[j] == lb[i] and iou[j, i] > cfg["iou_threshold"] for j in kept):
                continue
            kept.append(i)
        out.append({"boxes": bx[kept], "scores": cf[kept], "classes": lb[kept], "anchors": order[kept]})
    return out


def conv_flops(cfg: dict, img_size: int) -> float:
    """Operations of one image's forward, 2 a multiply-add, from the conv
    sites' shapes (the DFL expectation, pools and activations left out)."""
    return sum(s["ops"] for s in site_work(cfg, img_size))


def layer_sizes(cfg: dict, img_size: int) -> dict:
    """``{layer: (input side, output side)}``: each layer takes the one
    before it, a concatenation its sources (of one size)."""
    sizes, hw = {}, img_size
    for i, kind, a in architecture(cfg):
        hin = hw
        if kind == "conv":
            hw //= a[3]
        elif kind == "up":
            hw *= 2
        elif kind == "cat":
            hin = hw = sizes[a[1]][1]
        sizes[i] = (hin, hw)
    return sizes


def site_work(cfg: dict, img_size: int) -> list[dict]:
    """Per conv site of one image: input and output sides, the operations
    (2 a multiply-add) and the bf16 bytes of input, weights and output each
    read or written once; ``block`` names the C2f a site belongs to."""
    sizes = layer_sizes(cfg, img_size)
    det = architecture(cfg)[-1][0]
    out = []
    for p, cin, cout, k, s, block in conv_sites(cfg):
        parts = p.split(".")
        layer = int(parts[1])
        hin = sizes[(15, 18, 21)[int(parts[3])]][1] if layer == det else sizes[layer][0]
        ho = hin // s
        out.append({"site": p, "block": block, "hw_in": hin, "hw_out": ho, "cin": cin, "cout": cout, "k": k,
                    "ops": 2.0 * ho * ho * cout * cin * k * k, "in_bytes": 2.0 * hin * hin * cin,
                    "w_bytes": 2.0 * cout * cin * k * k, "out_bytes": 2.0 * ho * ho * cout})
    return out
