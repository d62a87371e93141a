"""Plain YOLO12 detect forward (float32, NCHW) over an Ultralytics-layout
state dict (``model.<i>.…`` keys, BatchNorm unfolded), for the benchmark's
check: a copy of the program's ``reference_impl/yolo12.py`` (a test holds
the two to the same bits), loading nothing of the program, with the
benchmark's additions below.  TF32 is off for matmuls and cuDNN inside
`Model.forward`.

Written from Ultralytics' ``cfg/models/12/yolo12.yaml`` and its blocks
(``nn/modules/block.py``: ``AAttn``, ``ABlock``, ``A2C2f``, ``C3k2``,
``C3k``; ``nn/modules/head.py``: ``Detect`` with ``legacy=False``):

* a scale is ``[depth, width, max_channels]``; a width is
  ``ceil(min(c, max_channels) * width / 8) * 8``, a repeat count
  ``max(round(n * depth), 1)``;
* ``Conv`` is conv (no bias) + BatchNorm (eps 1e-3) + SiLU (``act=False``:
  no SiLU); ``DWConv`` a ``Conv`` grouped by channel;
* ``C3k2(c1, c2, n, c3k, e)``: ``c = c2 e``, ``cv1`` to ``2 c``, split in
  two, ``n`` modules chained on the last part (``C3k(c, c, 2)`` or a
  ``Bottleneck`` with a hidden width of ``c / 2``), ``cv2`` of the
  concatenation; at m, l and x every ``C3k2`` takes ``c3k``;
* ``A2C2f(c1, c2, n, a2, area)``: ``c_ = c2 / 2``, ``y = [cv1(x)]``, each
  module (two ``ABlock(c_, c_ / 32 heads)`` or a ``C3k``) on ``y[-1]``,
  ``cv2`` of the concatenation, ``x + gamma * out`` where ``a2`` and
  ``residual`` (scales l and x, with an MLP ratio of 1.2; 2.0 below);
* ``AAttn``: ``qkv`` (``Conv`` without SiLU, channels grouped by head as
  ``q | k | v``), the tokens in row-major order cut into ``area`` contiguous
  runs, ``softmax(q k^T hd^-0.5) v`` per run and head, ``proj(x + pe(v))``
  with ``pe`` a 7x7 depthwise ``Conv`` without SiLU;
* ``Detect``: per level the box branch ``Conv 3x3``, ``Conv 3x3``, a biased
  1x1 to ``4 reg_max``, and the class branch ``DWConv 3x3``, ``Conv 1x1``,
  ``DWConv 3x3``, ``Conv 1x1``, a biased 1x1 to the classes.

Departures: the stride-2 convs are ungrouped (the parameter counts the
published table gives hold only so); the DFL's frozen ``arange`` projection
is in the layout but applied by the decode, not here; a map whose tokens
the area count does not divide is refused by name (Ultralytics' reshape
fails there).

Additions: ``fp8=True`` is the check's control (every conv's input and
weight, and the attention's ``q``, ``k``, probabilities and ``v``, rounded
to float8 e4m3 with a per-tensor scale before the float32 product);
`site_work` and `attention_work` count one image's operations and bytes;
the decode and the detections are `reference.yolo`'s (the same DFL head).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.yolo import _fp8

SCALES = {"n": (0.50, 0.25, 1024), "s": (0.50, 0.50, 1024), "m": (0.50, 1.00, 512),
          "l": (1.00, 1.00, 512), "x": (1.00, 1.50, 512)}
HEAD = 21  # the Detect layer's index


def widths(variant: str) -> list[int]:
    _, width, cap = SCALES[variant]
    return [int(math.ceil(min(c, cap) * width / 8) * 8) for c in (64, 128, 256, 512, 1024)]


def repeats(variant: str, n: int) -> int:
    return max(round(n * SCALES[variant][0]), 1)


def architecture(variant: str) -> list[tuple]:
    """``yolo12.yaml`` at a scale: per layer ``(index, kind, args)``: conv
    (cin, cout, k, s), c3k2 (cin, cout, n, c3k, e), a2c2f (cin, cout, n, a2,
    area), up, cat (sources), detect (input widths)."""
    c = widths(variant)
    n2, n4, c3k = repeats(variant, 2), repeats(variant, 4), variant in "mlx"
    return [
        (0, "conv", (3, c[0], 3, 2)), (1, "conv", (c[0], c[1], 3, 2)), (2, "c3k2", (c[1], c[2], n2, c3k, 0.25)),
        (3, "conv", (c[2], c[2], 3, 2)), (4, "c3k2", (c[2], c[3], n2, c3k, 0.25)), (5, "conv", (c[3], c[3], 3, 2)),
        (6, "a2c2f", (c[3], c[3], n4, True, 4)), (7, "conv", (c[3], c[4], 3, 2)), (8, "a2c2f", (c[4], c[4], n4, True, 1)),
        (9, "up", ()), (10, "cat", (9, 6)), (11, "a2c2f", (c[4] + c[3], c[3], n2, False, -1)),
        (12, "up", ()), (13, "cat", (12, 4)), (14, "a2c2f", (c[3] + c[3], c[2], n2, False, -1)),
        (15, "conv", (c[2], c[2], 3, 2)), (16, "cat", (15, 11)), (17, "a2c2f", (c[2] + c[3], c[3], n2, False, -1)),
        (18, "conv", (c[3], c[3], 3, 2)), (19, "cat", (18, 8)), (20, "c3k2", (c[3] + c[4], c[4], n2, True, 0.5)),
        (HEAD, "detect", (c[2], c[3], c[4])),
    ]


def head_widths(variant: str, num_classes: int, reg_max: int = 16) -> tuple[int, int]:
    """``Detect``'s box and class branch widths: ``max(16, P3 / 4, 4
    reg_max)`` and ``max(P3, min(nc, 100))``."""
    p3 = widths(variant)[2]
    return max(16, p3 // 4, reg_max * 4), max(p3, min(num_classes, 100))


def _big(variant: str) -> bool:
    return variant in "lx"


def mlp_ratio(variant: str) -> float:
    return 1.2 if _big(variant) else 2.0


def conv_sites(variant: str, num_classes: int, reg_max: int = 16) -> list[tuple]:
    """Every ``Conv`` of the model and the head's biased output convs:
    ``(key prefix, cin, cout, k, stride, groups, act, biased)``."""
    out = []

    def conv(p, cin, cout, k=1, s=1, g=1, act=True):
        out.append((p, cin, cout, k, s, g, act, False))

    def c3k(p, c1, c2):
        h = int(c2 * 0.5)
        conv(f"{p}.cv1", c1, h)
        conv(f"{p}.cv2", c1, h)
        for j in range(2):
            conv(f"{p}.m.{j}.cv1", h, h, 3)
            conv(f"{p}.m.{j}.cv2", h, h, 3)
        conv(f"{p}.cv3", 2 * h, c2)

    for i, kind, a in architecture(variant):
        p = f"model.{i}"
        if kind == "conv":
            conv(p, a[0], a[1], a[2], a[3])
        elif kind == "c3k2":
            cin, cout, n, use_c3k, e = a
            c = int(cout * e)
            conv(f"{p}.cv1", cin, 2 * c)
            for j in range(n):
                if use_c3k:
                    c3k(f"{p}.m.{j}", c, c)
                else:
                    conv(f"{p}.m.{j}.cv1", c, c // 2, 3)
                    conv(f"{p}.m.{j}.cv2", c // 2, c, 3)
            conv(f"{p}.cv2", (2 + n) * c, cout)
        elif kind == "a2c2f":
            cin, cout, n, a2, _ = a
            c = cout // 2
            hidden = int(c * mlp_ratio(variant))
            conv(f"{p}.cv1", cin, c)
            for j in range(n):
                if a2:
                    for b in range(2):
                        q = f"{p}.m.{j}.{b}"
                        conv(f"{q}.attn.qkv", c, 3 * c, act=False)
                        conv(f"{q}.attn.proj", c, c, act=False)
                        conv(f"{q}.attn.pe", c, c, 7, 1, c, act=False)
                        conv(f"{q}.mlp.0", c, hidden)
                        conv(f"{q}.mlp.1", hidden, c, act=False)
                else:
                    c3k(f"{p}.m.{j}", c, c)
            conv(f"{p}.cv2", (1 + n) * c, cout)
        elif kind == "detect":
            c2, c3 = head_widths(variant, num_classes, reg_max)
            for lvl, f in enumerate(a):
                conv(f"{p}.cv2.{lvl}.0", f, c2, 3)
                conv(f"{p}.cv2.{lvl}.1", c2, c2, 3)
                out.append((f"{p}.cv2.{lvl}.2", c2, 4 * reg_max, 1, 1, 1, False, True))
                conv(f"{p}.cv3.{lvl}.0.0", f, f, 3, 1, f)
                conv(f"{p}.cv3.{lvl}.0.1", f, c3)
                conv(f"{p}.cv3.{lvl}.1.0", c3, c3, 3, 1, c3)
                conv(f"{p}.cv3.{lvl}.1.1", c3, c3)
                out.append((f"{p}.cv3.{lvl}.2", c3, num_classes, 1, 1, 1, False, True))
    return out


def state_layout(variant: str, num_classes: int, reg_max: int = 16) -> list[tuple[str, tuple]]:
    """Every tensor of the Ultralytics state dict: ``(key, shape)``, with
    each ``A2C2f``'s ``gamma`` (scales l and x) and the DFL's projection."""
    out = []
    for p, cin, cout, k, _, g, _, biased in conv_sites(variant, num_classes, reg_max):
        if biased:
            out += [(f"{p}.weight", (cout, cin // g, k, k)), (f"{p}.bias", (cout,))]
        else:
            out.append((f"{p}.conv.weight", (cout, cin // g, k, k)))
            out += [(f"{p}.bn.{n}", (cout,)) for n in ("weight", "bias", "running_mean", "running_var")]
    if _big(variant):
        out += [(f"model.{i}.gamma", (a[1],)) for i, kind, a in architecture(variant) if kind == "a2c2f" and a[3]]
    out.append((f"model.{HEAD}.dfl.conv.weight", (1, reg_max, 1, 1)))
    return out


class Model:
    """The forward over a state dict (tensors on the model's device).
    ``cfg`` holds ``variant``, ``num_classes``, ``reg_max`` and ``bn_eps``."""

    def __init__(self, cfg: dict, sd: dict, fp8: bool = False):
        self.cfg, self.fp8 = cfg, fp8
        self.variant = cfg["variant"]
        self.sd = {k: v.to(torch.float32) for k, v in sd.items()}
        self.calibrating = False
        self.kept: dict[int, torch.Tensor] = {}

    def conv(self, x, p, stride=1, groups=1, act=True):
        sd = self.sd
        w = sd[f"{p}.conv.weight"]
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        y = F.conv2d(x, w, None, stride, w.shape[-1] // 2, 1, groups)
        if self.calibrating:
            sd[f"{p}.bn.running_mean"] = y.mean((0, 2, 3))
            sd[f"{p}.bn.running_var"] = y.var((0, 2, 3), unbiased=False)
        y = F.batch_norm(y, sd[f"{p}.bn.running_mean"], sd[f"{p}.bn.running_var"], sd[f"{p}.bn.weight"],
                         sd[f"{p}.bn.bias"], False, 0.0, self.cfg["bn_eps"])
        return F.silu(y) if act else y

    def attention(self, q, k, v):
        """``q, k, v (B', heads, hd, N')`` -> ``v @ softmax(q^T k hd^-0.5)^T``."""
        if self.fp8:
            q, k, v = _fp8(q), _fp8(k), _fp8(v)
        attn = (q.transpose(-2, -1) @ k) * (q.shape[2] ** -0.5)
        probs = attn.softmax(dim=-1)
        if self.fp8:
            probs = _fp8(probs)
        return v @ probs.transpose(-2, -1)

    def aattn(self, x, p, area):
        b, c, h, w = x.shape
        n, heads = h * w, c // 32
        hd = c // heads
        if n % area:
            raise ValueError(f"area attention: a {h} x {w} map does not split into {area} areas of equal length")
        qkv = self.conv(x, f"{p}.qkv", act=False).flatten(2).transpose(1, 2)
        bb, nn_ = (b * area, n // area) if area > 1 else (b, n)
        qkv = qkv.reshape(bb, nn_, 3 * c)
        q, k, v = qkv.view(bb, nn_, heads, 3 * hd).permute(0, 2, 3, 1).split([hd, hd, hd], dim=2)
        y = self.attention(q, k, v).permute(0, 3, 1, 2)
        v = v.permute(0, 3, 1, 2)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        v = v.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.conv(y + self.conv(v, f"{p}.pe", groups=c, act=False), f"{p}.proj", act=False)

    def ablock(self, x, p, area):
        x = x + self.aattn(x, f"{p}.attn", area)
        return x + self.conv(self.conv(x, f"{p}.mlp.0"), f"{p}.mlp.1", act=False)

    def bottleneck(self, x, p):
        return x + self.conv(self.conv(x, f"{p}.cv1"), f"{p}.cv2")

    def c3k(self, x, p):
        y = self.conv(x, f"{p}.cv1")
        for j in range(2):
            y = self.bottleneck(y, f"{p}.m.{j}")
        return self.conv(torch.cat([y, self.conv(x, f"{p}.cv2")], 1), f"{p}.cv3")

    def c3k2(self, x, p, n, use_c3k):
        y = list(self.conv(x, f"{p}.cv1").chunk(2, 1))
        for j in range(n):
            y.append(self.c3k(y[-1], f"{p}.m.{j}") if use_c3k else self.bottleneck(y[-1], f"{p}.m.{j}"))
        return self.conv(torch.cat(y, 1), f"{p}.cv2")

    def a2c2f(self, x, p, n, a2, area):
        y = [self.conv(x, f"{p}.cv1")]
        for j in range(n):
            if a2:
                z = y[-1]
                for b in range(2):
                    z = self.ablock(z, f"{p}.m.{j}.{b}", area)
                y.append(z)
            else:
                y.append(self.c3k(y[-1], f"{p}.m.{j}"))
        out = self.conv(torch.cat(y, 1), f"{p}.cv2")
        gamma = self.sd.get(f"{p}.gamma")
        return out if gamma is None or not a2 else x + gamma.view(1, -1, 1, 1) * out

    def detect(self, feats, p):
        levels = []
        for lvl, f in enumerate(feats):
            box = self.conv(self.conv(f, f"{p}.cv2.{lvl}.0"), f"{p}.cv2.{lvl}.1")
            cls = self.conv(self.conv(f, f"{p}.cv3.{lvl}.0.0", groups=f.shape[1]), f"{p}.cv3.{lvl}.0.1")
            cls = self.conv(self.conv(cls, f"{p}.cv3.{lvl}.1.0", groups=cls.shape[1]), f"{p}.cv3.{lvl}.1.1")
            levels.append(tuple(F.conv2d(_fp8(z) if self.fp8 else z, _fp8(self.sd[f"{p}.{cv}.{lvl}.2.weight"])
                                         if self.fp8 else self.sd[f"{p}.{cv}.{lvl}.2.weight"],
                                         self.sd[f"{p}.{cv}.{lvl}.2.bias"])
                                for cv, z in (("cv2", box), ("cv3", cls))))
        return levels

    def forward(self, images: torch.Tensor, keep: tuple = ()) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """``(B, 3, H, W)`` float in [0, 1] -> per level ``(box logits (B,
        4 reg_max, h, w), class logits (B, nc, h, w))``; the outputs of the
        layers ``keep`` names (Ultralytics' indices) are left in
        ``self.kept``."""
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            outs = {}
            x = images.to(torch.float32)
            for i, kind, a in architecture(self.variant):
                p = f"model.{i}"
                if kind == "conv":
                    x = self.conv(x, p, a[3])
                elif kind == "c3k2":
                    x = self.c3k2(x, p, a[2], a[3])
                elif kind == "a2c2f":
                    x = self.a2c2f(x, p, a[2], a[3], a[4])
                elif kind == "up":
                    x = F.interpolate(x, scale_factor=2, mode="nearest")
                elif kind == "cat":
                    x = torch.cat([outs[j] for j in a], 1)
                else:
                    self.kept = {j: outs[j] for j in keep}
                    return self.detect([outs[j] for j in (14, 17, 20)], p)
                outs[i] = x
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        raise AssertionError("no detect layer")


def calibrate(cfg: dict, sd: dict, images: torch.Tensor) -> dict:
    """``sd`` with every BatchNorm's running statistics set to those of its
    conv's output over ``images`` (NCHW), layer after layer in one forward."""
    model = Model(cfg, sd)
    model.calibrating = True
    with torch.no_grad():
        model.forward(images)
    return {k: model.sd[k].to(v.dtype) for k, v in sd.items()}


KERNEL_SITES = ((1, 1), (3, 1), (3, 2))  # (k, stride) of the program's fused conv kernels


def layer_sizes(variant: str, img_size: int) -> dict:
    """``{layer: (input side, output side)}``: each layer takes the one
    before it, a concatenation its sources (of one size)."""
    sizes, hw = {}, img_size
    for i, kind, a in architecture(variant):
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
    read or written once; ``kernel`` says whether the program runs it in its
    fused conv kernels (dense, a (k, stride) they take, SiLU or a 1x1)."""
    sizes = layer_sizes(cfg["variant"], img_size)
    out = []
    for p, cin, cout, k, s, g, act, biased in conv_sites(cfg["variant"], cfg["num_classes"], cfg["reg_max"]):
        parts = p.split(".")
        layer = int(parts[1])
        hin = sizes[(14, 17, 20)[int(parts[3])]][1] if layer == HEAD else sizes[layer][0]
        ho = hin // s
        out.append({"site": p, "hw_in": hin, "hw_out": ho, "cin": cin, "cout": cout, "k": k, "groups": g,
                    "kernel": g == 1 and (k, s) in KERNEL_SITES and (act or k == 1),
                    "ops": 2.0 * ho * ho * cout * (cin // g) * k * k, "in_bytes": 2.0 * hin * hin * cin,
                    "w_bytes": 2.0 * cout * (cin // g) * k * k, "out_bytes": 2.0 * ho * ho * cout})
    return out


def conv_flops(cfg: dict, img_size: int) -> float:
    """Operations of one image's convs, 2 a multiply-add."""
    return sum(s["ops"] for s in site_work(cfg, img_size))


def attention_work(cfg: dict, img_size: int) -> list[dict]:
    """Per ``AAttn`` of one image: its tokens ``T`` an area, ``area``,
    ``heads`` and head size ``hd``; ``scores`` (``area heads T^2``), the two
    products' operations (``4 T^2 hd heads area``) and the bf16 bytes of q,
    k, v and the output each once."""
    sizes = layer_sizes(cfg["variant"], img_size)
    out = []
    for i, kind, a in architecture(cfg["variant"]):
        if kind != "a2c2f" or not a[3]:
            continue
        c, area, side = a[1] // 2, a[4], sizes[i][1]
        heads, n = c // 32, side * side
        if n % area:
            raise ValueError(f"area attention: a {side} x {side} map does not split into {area} areas of equal length")
        t = n // area
        for j in range(a[2]):
            for b in range(2):
                out.append({"site": f"model.{i}.m.{j}.{b}.attn", "tokens": t, "area": area, "heads": heads,
                            "hd": c // heads, "scores": area * heads * t * t,
                            "ops": 4.0 * t * t * (c // heads) * heads * area, "bytes": 4 * 2.0 * n * c})
    return out
