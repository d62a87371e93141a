"""The YOLO detector in PyTorch: the counterpart of the JAX package's
``models/yolo.py`` (families v8, v11 and v12; variants n/s/m; tasks
detect, obb, segment, pose), and the published YOLO12 (``yolo12``, variants
n/s/m/l/x, detect), which the JAX package does not have.

Activations are NHWC (``(B, H, W, C)`` contiguous) at every
public function and between the modules, as in the JAX package, so outputs
compare like with like and the conv kernels take them as they are.  Child
modules carry the names flax gives them (``ConvBnAct_0``, ``Bottleneck_0``,
``Conv_3`` ...), so a checkpoint's tree maps onto the ``state_dict`` by rule
(`convert.detector_state_from_numpy`).

Parameters stay float32; ``dtype`` is the working type a module computes in
(inputs, weights and, except in the fused C2f, biases are cast to it).

Two conv paths, chosen by the caller through ``fused`` and never silently:
  * ``fused=True`` (needs ``folded``): every folded ``ConvBnAct`` with
    (kernel, stride) in {(1, 1), (3, 1), (3, 2)} and every plain 1x1 conv
    (the heads' outputs, the attention's projections, the 1x1 before a bare
    BatchNorm; no bias: a zero one) is one hand-written kernel (K5-K7,
    `ops/pallas/conv_fused`), and a v8 ``C2f`` with one bottleneck is one
    kernel as a whole (K8, `ops/pallas/c2f_fused`), as the JAX package's
    interceptors route them; the attention's depthwise 3x3 and its two
    products stay library calls, as they stay XLA's there;
  * ``fused=False``: ``F.conv2d`` + ``F.silu``, the counterpart of the JAX
    package's unfused path through XLA's conv emitter.

Every module starts in inference mode, a block built alone too.
Training: ``model.train()`` on an unfolded, unfused model (the JAX
package's ``apply(..., train=True)``).  In that mode every module computes
from its live parameters with autograd, casting them to the working type
inside the graph, and a BatchNorm normalises with the batch's statistics
as flax's
``nn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)``
does: mean and biased variance ``E[x^2] - E[x]^2`` (clipped at 0) in
float32 whatever the working type, and running statistics updated as
``0.97 * running + 0.03 * batch``, the biased variance included.

The memo: at inference a module keeps cast or re-laid copies of its
parameters (`_Cached`), dropped when the module is moved or reloaded and
at every ``train()``/``eval()``, so the weights an optimizer moved in
training mode are read again.  Training mode neither reads nor fills it;
a weight changed in place at inference needs a ``model.eval()`` after it.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from icp_slam_yolo_tpu_torch.ops.attention import area_attention
from icp_slam_yolo_tpu_torch.ops.pallas import c2f_fused as c2f_kernel
from icp_slam_yolo_tpu_torch.ops.pallas import conv_fused as conv_kernels
from icp_slam_yolo_tpu_torch.parallel import distributed

BN_EPS = 1e-3
BN_MOMENTUM = 0.97  # flax's: running = 0.97 * running + 0.03 * batch
_FUSED_SITES = ((1, 1), (3, 1), (3, 2))


def _make_divisible(x: float, div: int = 8) -> int:
    return max(div, int(round(x / div) * div))


class _Cached(nn.Module):
    """A module that keeps cast or re-laid copies of its parameters for
    inference, made at first use and dropped when the module is moved,
    reloaded or switched between training and inference."""

    def __init__(self):
        super().__init__()
        self._memo = {}
        self.training = False  # inference until `train()` opts in, as alone as inside a YOLO

    def _apply(self, *args, **kwargs):
        self._memo = {}
        return super()._apply(*args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._memo = {}
        return super()._load_from_state_dict(*args, **kwargs)

    def train(self, mode: bool = True):
        self._memo = {}  # the optimizer steps between a train() and the next eval() change the weights
        return super().train(mode)

    def _cached(self, key, make):
        if key not in self._memo:
            with torch.no_grad():
                self._memo[key] = make()
        return self._memo[key]


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d, channel_dim: int) -> torch.Tensor:
    """flax's ``nn.BatchNorm`` in training mode on ``x`` (channels on
    ``channel_dim``): the batch's float32 mean and biased variance ``E[x^2]
    - E[x]^2`` clipped at 0, ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in float32, cast back to ``x``'s type; the running statistics
    move to ``0.97 * running + 0.03 * batch`` (the biased variance:
    ``F.batch_norm`` would store the unbiased one).

    Inside `distributed.data_parallel`, the batch is the global one, as
    under JAX's ``jit`` with the batch sharded: one all-reduce (in the
    autograd graph) of the per-channel sums of ``x`` and ``x^2`` and of the
    count, then the same moments, the same on every rank."""
    dims = tuple(d for d in range(x.dim()) if d != channel_dim)
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    xf = x.to(torch.promote_types(x.dtype, torch.float32))  # float32 at least, as flax computes them
    if distributed.data_parallel_group() is None:
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
    else:
        c = x.shape[channel_dim]
        sums = distributed.global_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                                 xf.new_full((1,), float(x.numel() // c))]))
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp(sums[c: 2 * c] / sums[2 * c] - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + BN_EPS) * bn.weight
    return ((xf - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)).to(x.dtype)


def _live(t: torch.Tensor | None, dt) -> torch.Tensor | None:
    """A parameter cast to the working type inside the autograd graph."""
    return None if t is None else t.to(dt)


def _hwio(conv: nn.Conv2d, dtype) -> torch.Tensor:
    """A conv's OIHW weight as a contiguous HWIO tensor in ``dtype``: the
    layout the kernels read, made once."""
    return conv.weight.detach().permute(2, 3, 1, 0).to(dtype).contiguous()


class ConvBnAct(_Cached):
    """Conv + BatchNorm + SiLU; ``folded=True`` is the inference form with the
    BN affine absorbed into a biased conv (`fold_batchnorm`).  ``act=False``
    drops the SiLU and ``groups`` groups the conv (Ultralytics' ``Conv(...,
    g=groups, act=False)``); a grouped conv, or a 3x3 without SiLU, never
    takes the kernels, which compute a dense conv with SiLU there."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 dtype=torch.float32, folded: bool = False, fused: bool = False, *, act: bool = True,
                 groups: int = 1):
        super().__init__()
        self.kernel, self.stride, self.dtype, self.folded, self.fused = kernel, stride, dtype, folded, fused
        self.act, self.groups = act, groups
        self.conv = nn.Conv2d(cin, features, kernel, stride, kernel // 2, groups=groups, bias=folded)
        self.bn = None if folded else nn.BatchNorm2d(features, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)

    def uses_kernels(self) -> bool:
        """Whether this site runs in K5-K7 (folded, fused, dense, and a
        shape and activation the kernels compute)."""
        return (self.fused and self.folded and self.groups == 1 and (self.kernel, self.stride) in _FUSED_SITES
                and (self.act or self.kernel == 1))

    def fused_params(self):
        """``(w HWIO, b)`` in the working type: what K5-K7 take (the bias is
        rounded to the working type, as the JAX dispatch does)."""
        return self._cached("fused", lambda: (_hwio(self.conv, self.dtype), self.conv.bias.detach().to(self.dtype)))

    def forward(self, x):
        dt = self.dtype
        if self.training:
            y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), _live(self.conv.weight, dt), _live(self.conv.bias, dt),
                         self.stride, self.kernel // 2, 1, self.groups)
            if not self.folded:
                y = batch_norm_train(y, self.bn, 1)
            return (F.silu(y) if self.act else y).permute(0, 2, 3, 1)
        if self.uses_kernels():
            w, b = self.fused_params()
            x = x.to(dt).contiguous()
            if self.kernel == 1:
                return conv_kernels.conv1x1_silu(x, w[0, 0], b, act=self.act)
            if self.stride == 2:
                return conv_kernels.conv3x3s2_silu(x, w, b)
            return conv_kernels.conv3x3_silu(x, w, b)
        w, b = self._cached("plain", lambda: (
            self.conv.weight.detach().to(dt),
            None if self.conv.bias is None else self.conv.bias.detach().to(dt)))
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), w, b, self.stride, self.kernel // 2, 1, self.groups)
        if not self.folded:
            mean, var, g, beta = self._cached("bn", lambda: tuple(
                t.detach().to(dt) for t in (self.bn.running_mean, self.bn.running_var, self.bn.weight, self.bn.bias)))
            y = F.batch_norm(y, mean, var, g, beta, False, 0.0, BN_EPS)
        return (F.silu(y) if self.act else y).permute(0, 2, 3, 1)


class Conv1x1(_Cached):
    """A plain 1x1 conv without activation: the heads' outputs (biased), the
    attention's projections and the 1x1 before a bare BatchNorm (no bias;
    the fused path gives K5 a zero one, as the JAX dispatch does)."""

    def __init__(self, cin: int, features: int, dtype=torch.float32, fused: bool = False, bias: bool = True):
        super().__init__()
        self.dtype, self.fused = dtype, fused
        self.conv = nn.Conv2d(cin, features, 1, bias=bias)

    def _bias(self, dt):
        b = self.conv.bias
        return torch.zeros(self.conv.out_channels, dtype=dt, device=self.conv.weight.device) if b is None \
            else b.detach().to(dt)

    def forward(self, x):
        dt = self.dtype
        if self.training:
            return F.conv2d(x.to(dt).permute(0, 3, 1, 2), _live(self.conv.weight, dt),
                            _live(self.conv.bias, dt)).permute(0, 2, 3, 1)
        if self.fused:
            w, b = self._cached("fused", lambda: (_hwio(self.conv, dt)[0, 0].contiguous(), self._bias(dt)))
            return conv_kernels.conv1x1_silu(x.to(dt).contiguous(), w, b, act=False)
        w, b = self._cached("plain", lambda: (
            self.conv.weight.detach().to(dt), None if self.conv.bias is None else self.conv.bias.detach().to(dt)))
        return F.conv2d(x.to(dt).permute(0, 3, 1, 2), w, b).permute(0, 2, 3, 1)


class DepthwiseConv3x3(_Cached):
    """A 3x3 depthwise conv without bias or activation (the attention's
    positional term on V): ``F.conv2d`` with ``groups=c`` on every path."""

    def __init__(self, c: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(c, c, 3, 1, 1, groups=c, bias=False)

    def forward(self, x):
        w = _live(self.conv.weight, self.dtype) if self.training else \
            self._cached("plain", lambda: self.conv.weight.detach().to(self.dtype))
        return F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w, None, 1, 1, 1, w.shape[0]).permute(0, 2, 3, 1)


class BatchNorm(nn.BatchNorm2d):
    """A bare BatchNorm on NHWC, computed as flax computes it: at inference
    with the running statistics, in float32, ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias``, then cast to the working type; in training mode
    with the batch's (`batch_norm_train`).  It stays in the folded model:
    only a ConvBnAct's BatchNorm folds."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__(features, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)
        self.dtype = dtype
        self.training = False  # inference until `train()` opts in

    def forward(self, x):
        if self.training:
            return batch_norm_train(x, self, x.dim() - 1).to(self.dtype)
        mul = torch.rsqrt(self.running_var.float() + BN_EPS) * self.weight.float()
        return ((x.float() - self.running_mean.float()) * mul + self.bias.float()).to(self.dtype)


class Bottleneck(nn.Module):
    """Two 3x3 ``ConvBnAct``s, the first to ``int(features * e)`` channels,
    with a shortcut where ``cin == features``."""

    def __init__(self, cin: int, features: int, shortcut: bool = True, e: float = 1.0, **kw):
        super().__init__()
        self.shortcut = shortcut and cin == features
        hidden = int(features * e)
        self.ConvBnAct_0 = ConvBnAct(cin, hidden, 3, **kw)
        self.ConvBnAct_1 = ConvBnAct(hidden, features, 3, **kw)

    def forward(self, x):
        y = self.ConvBnAct_1(self.ConvBnAct_0(x))
        return x + y if self.shortcut else y


class C2f(_Cached):
    """Cross-stage partial block with ``n`` bottlenecks.  Folded, fused and
    with ``n == 1`` it runs as one kernel (K8); the shortcut flag is the
    module's own (``self.shortcut``), whatever the block is called."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = False,
                 dtype=torch.float32, folded: bool = False, fused: bool = False):
        super().__init__()
        self.features, self.n, self.shortcut = features, n, shortcut
        self.dtype, self.folded, self.fused = dtype, folded, fused
        kw = dict(dtype=dtype, folded=folded, fused=fused)
        c = features // 2
        self.ConvBnAct_0 = ConvBnAct(cin, 2 * c, 1, **kw)
        for i in range(n):
            self.add_module(f"Bottleneck_{i}", Bottleneck(c, c, shortcut, **kw))
        self.ConvBnAct_1 = ConvBnAct((2 + n) * c, features, 1, **kw)

    def whole_block_kernel(self) -> bool:
        return self.fused and self.folded and self.n == 1

    def fused_params(self):
        """K8's operands: weights HWIO in the working type, biases float32."""
        def make():
            dt = self.dtype
            m = self.Bottleneck_0
            convs = (self.ConvBnAct_0.conv, m.ConvBnAct_0.conv, m.ConvBnAct_1.conv, self.ConvBnAct_1.conv)
            w1, wm1, wm2, w2 = (_hwio(cv, dt) for cv in convs)
            b1, bm1, bm2, b2 = (cv.bias.detach().float().contiguous() for cv in convs)
            return (w1[0, 0].contiguous(), b1, wm1, bm1, wm2, bm2, w2[0, 0].contiguous(), b2)
        return self._cached("fused", make)

    def forward(self, x):
        if self.whole_block_kernel():
            return c2f_kernel.c2f_fused(x.to(self.dtype).contiguous(), *self.fused_params(),
                                        shortcut=self.Bottleneck_0.shortcut)
        c = self.features // 2
        y = self.ConvBnAct_0(x)
        parts = [y[..., :c], y[..., c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"Bottleneck_{i}")(parts[-1]))
        return self.ConvBnAct_1(torch.cat(parts, dim=-1))


class C3k(nn.Module):
    """CSP block with 3 convs and ``n`` hidden-width bottlenecks (the inner
    module of C3k2 with ``c3k=True`` and of A2C2f with ``a2=False``)."""

    def __init__(self, cin: int, features: int, n: int = 2, e: float = 0.5, **kw):
        super().__init__()
        self.n = n
        c = max(8, int(features * e))
        self.ConvBnAct_0 = ConvBnAct(cin, c, 1, **kw)
        self.ConvBnAct_1 = ConvBnAct(cin, c, 1, **kw)
        for i in range(n):
            self.add_module(f"Bottleneck_{i}", Bottleneck(c, c, True, **kw))
        self.ConvBnAct_2 = ConvBnAct(2 * c, features, 1, **kw)

    def forward(self, x):
        a, b = self.ConvBnAct_0(x), self.ConvBnAct_1(x)
        for i in range(self.n):
            a = getattr(self, f"Bottleneck_{i}")(a)
        return self.ConvBnAct_2(torch.cat([a, b], dim=-1))


class C3k2(nn.Module):
    """The v11/v12 CSP block: the C2f wiring with plain bottlenecks (shortcut
    on) or C3k inner modules.  No whole-block kernel takes it: its convs run
    one by one (the JAX package's C2f kernel matches only a C2f).  A plain
    bottleneck's hidden width is ``hidden`` times ``c`` (Ultralytics: 0.5;
    the JAX package's reading: 1.0)."""

    def __init__(self, cin: int, features: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 hidden: float = 1.0, **kw):
        super().__init__()
        self.n, self.c3k = n, c3k
        self.c = c = max(8, int(features * e))
        self.ConvBnAct_0 = ConvBnAct(cin, 2 * c, 1, **kw)
        for i in range(n):
            if c3k:
                self.add_module(f"C3k_{i}", C3k(c, c, 2, **kw))
            else:
                self.add_module(f"Bottleneck_{i}", Bottleneck(c, c, True, hidden, **kw))
        self.ConvBnAct_1 = ConvBnAct((2 + n) * c, features, 1, **kw)

    def forward(self, x):
        c = self.c
        y = self.ConvBnAct_0(x)
        parts = [y[..., :c], y[..., c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"{'C3k' if self.c3k else 'Bottleneck'}_{i}")(parts[-1]))
        return self.ConvBnAct_1(torch.cat(parts, dim=-1))


class Attention2d(nn.Module):
    """Multi-head self-attention over an NHWC map in ``area`` horizontal bands
    of the row-major flattened map (``area`` falls back to 1 where it does
    not divide ``h * w``).  A head's query and key take ``kd = max(hd // 2,
    8)`` channels of the value's ``hd``; a 3x3 depthwise conv on V adds the
    positional term.  The logits (scaled by ``kd ** -0.5``) and the softmax
    are float32; the probabilities are cast to V's type and the second
    product sums in float32, as the JAX package's two ``einsum``s with
    ``preferred_element_type=float32``.  Children as flax names them:
    ``Conv_0`` q, ``Conv_1`` k, ``Conv_2`` v, ``Conv_3`` the positional
    conv, ``Conv_4`` the output projection."""

    def __init__(self, c: int, num_heads: int, area: int = 1, dtype=torch.float32, fused: bool = False):
        super().__init__()
        self.c, self.nh, self.area, self.dtype = c, num_heads, area, dtype
        self.hd = c // num_heads
        self.kd = max(self.hd // 2, 8)
        kw = dict(dtype=dtype, fused=fused, bias=False)
        self.Conv_0 = Conv1x1(c, num_heads * self.kd, **kw)
        self.Conv_1 = Conv1x1(c, num_heads * self.kd, **kw)
        self.Conv_2 = Conv1x1(c, c, **kw)
        self.Conv_3 = DepthwiseConv3x3(c, dtype)
        self.Conv_4 = Conv1x1(c, c, **kw)

    def forward(self, x):
        b, h, w, c = x.shape
        nh, hd, kd = self.nh, self.hd, self.kd
        q, k, v = self.Conv_0(x), self.Conv_1(x), self.Conv_2(x)
        pe = self.Conv_3(v)
        n = h * w
        area = self.area if n % self.area == 0 else 1
        t = n // area

        def split(z, d):  # (B, H, W, nh * d) -> (B * area * nh, T, d)
            return z.reshape(b, area, t, nh, d).permute(0, 1, 3, 2, 4).reshape(b * area * nh, t, d)

        qs, ks, vs = split(q, kd), split(k, kd), split(v, hd)
        logits = torch.matmul(qs.float(), ks.float().transpose(1, 2)) * (kd ** -0.5)
        attn = torch.softmax(logits, dim=-1).to(vs.dtype)
        out = torch.matmul(attn.float(), vs.float()).to(self.dtype)
        out = out.reshape(b, area, nh, t, hd).permute(0, 1, 3, 2, 4).reshape(b, h, w, c)
        return self.Conv_4(out + pe)


class _AttentionBlock(nn.Module):
    """Attention, then a conv FFN (a ConvBnAct to ``mid`` channels, a plain
    1x1 back, a bare BatchNorm), both residual."""

    def __init__(self, features: int, num_heads: int, area: int, mid: int, dtype=torch.float32,
                 folded: bool = False, fused: bool = False):
        super().__init__()
        self.Attention2d_0 = Attention2d(features, num_heads, area, dtype=dtype, fused=fused)
        self.ConvBnAct_0 = ConvBnAct(features, mid, 1, dtype=dtype, folded=folded, fused=fused)
        self.Conv_0 = Conv1x1(mid, features, dtype=dtype, fused=fused, bias=False)
        self.BatchNorm_0 = BatchNorm(features, dtype)

    def forward(self, x):
        x = x + self.Attention2d_0(x)
        return x + self.BatchNorm_0(self.Conv_0(self.ConvBnAct_0(x)))


class PSABlock(_AttentionBlock):
    """v11's position-sensitive attention block: a head per 64 channels, a
    2x wide FFN."""

    def __init__(self, features: int, **kw):
        super().__init__(features, max(features // 64, 1), 1, features * 2, **kw)


class C2PSA(nn.Module):
    """The CSP-wrapped PSA stack after SPPF (v11's backbone tail)."""

    def __init__(self, cin: int, features: int, n: int = 1, **kw):
        super().__init__()
        self.n = n
        self.c = c = features // 2
        self.ConvBnAct_0 = ConvBnAct(cin, 2 * c, 1, **kw)
        for i in range(n):
            self.add_module(f"PSABlock_{i}", PSABlock(c, **kw))
        self.ConvBnAct_1 = ConvBnAct(2 * c, features, 1, **kw)

    def forward(self, x):
        c = self.c
        y = self.ConvBnAct_0(x)
        a, rest = y[..., :c], y[..., c:]
        for i in range(self.n):
            a = getattr(self, f"PSABlock_{i}")(a)
        return self.ConvBnAct_1(torch.cat([a, rest], dim=-1))


class ABlock(_AttentionBlock):
    """v12's area-attention block: a head per 32 channels, a 1.2x wide FFN."""

    def __init__(self, features: int, area: int = 1, **kw):
        super().__init__(features, max(features // 32, 1), area, max(8, int(features * 1.2)), **kw)


class A2C2f(nn.Module):
    """v12's R-ELAN block: the C2f wiring whose inner modules are pairs of
    area-attention blocks (``a2=True``) or C3k blocks, with a learned
    residual scale ``gamma`` where ``a2`` is set and the input is
    ``features`` wide."""

    def __init__(self, cin: int, features: int, n: int = 1, a2: bool = True, area: int = 1, e: float = 0.5, **kw):
        super().__init__()
        self.n, self.a2 = n, a2
        c = max(8, int(features * e))
        self.ConvBnAct_0 = ConvBnAct(cin, c, 1, **kw)
        for i in range(n):
            if a2:
                self.add_module(f"ABlock_{2 * i}", ABlock(c, area, **kw))
                self.add_module(f"ABlock_{2 * i + 1}", ABlock(c, area, **kw))
            else:
                self.add_module(f"C3k_{i}", C3k(c, c, 2, **kw))
        self.ConvBnAct_1 = ConvBnAct((1 + n) * c, features, 1, **kw)
        self.gamma = nn.Parameter(torch.full((features,), 0.01)) if a2 and cin == features else None

    def forward(self, x):
        parts = [self.ConvBnAct_0(x)]
        for i in range(self.n):
            z = parts[-1]
            if self.a2:
                z = getattr(self, f"ABlock_{2 * i + 1}")(getattr(self, f"ABlock_{2 * i}")(z))
            else:
                z = getattr(self, f"C3k_{i}")(z)
            parts.append(z)
        out = self.ConvBnAct_1(torch.cat(parts, dim=-1))
        return out if self.gamma is None else x + self.gamma.to(out.dtype) * out


class AAttn(nn.Module):
    """YOLO12's area attention as Ultralytics publishes it (``AAttn``): a
    head per 32 channels; ``qkv``, a 1x1 ``Conv`` without SiLU to ``3 dim``
    channels grouped by head (head ``j`` owns ``[3 hd j, 3 hd (j + 1))`` as
    ``q | k | v``); the products over ``area`` bands (`ops.attention`); ``pe``,
    a 7x7 depthwise ``Conv`` without SiLU on ``v`` laid out as the map; and
    ``proj``, a 1x1 ``Conv`` without SiLU of their sum.  ``qkv`` and ``proj``
    take K5 on the fused path, ``pe`` and the products library calls."""

    def __init__(self, dim: int, heads: int, area: int = 1, **kw):
        super().__init__()
        self.heads, self.area = heads, area
        self.qkv = ConvBnAct(dim, 3 * dim, 1, act=False, **kw)
        self.proj = ConvBnAct(dim, dim, 1, act=False, **kw)
        self.pe = ConvBnAct(dim, dim, 7, act=False, groups=dim, **kw)

    def forward(self, x):
        qkv = self.qkv(x)
        b, h, w, c3 = qkv.shape
        v = qkv.view(b, h, w, self.heads, 3, c3 // (3 * self.heads))[..., 2, :].reshape(b, h, w, c3 // 3)
        return self.proj(area_attention(qkv, self.heads, self.area) + self.pe(v))


class ABlock12(nn.Module):
    """YOLO12's ``ABlock``: ``x + AAttn(x)``, then ``x + mlp(x)`` with
    ``mlp`` a 1x1 ``Conv`` to ``int(dim * mlp_ratio)`` channels and a 1x1
    ``Conv`` without SiLU back."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 1.2, area: int = 1, **kw):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.attn = AAttn(dim, heads, area, **kw)
        self.mlp = nn.Sequential(ConvBnAct(dim, hidden, 1, **kw), ConvBnAct(hidden, dim, 1, act=False, **kw))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f12(nn.Module):
    """YOLO12's R-ELAN block (``A2C2f``): ``y = [cv1(x)]``, each of the ``n``
    modules on ``y[-1]`` (two ``ABlock12`` with ``a2``, else a ``C3k``),
    ``out = cv2(cat y)``, and ``x + gamma * out`` where ``a2`` and
    ``residual`` (scales l and x)."""

    def __init__(self, cin: int, features: int, n: int = 1, a2: bool = True, area: int = 1,
                 residual: bool = False, mlp_ratio: float = 2.0, **kw):
        super().__init__()
        c = int(features * 0.5)
        if a2 and c % 32:
            raise ValueError(f"A2C2f: {c} hidden channels, not a multiple of the 32 of a head")
        self.cv1 = ConvBnAct(cin, c, 1, **kw)
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock12(c, c // 32, mlp_ratio, area, **kw) for _ in range(2))) if a2
            else C3k(c, c, 2, **kw) for _ in range(n))
        self.cv2 = ConvBnAct((1 + n) * c, features, 1, **kw)
        self.gamma = nn.Parameter(torch.full((features,), 0.01)) if a2 and residual else None

    def forward(self, x):
        y = [self.cv1(x)]
        for m in self.m:
            y.append(m(y[-1]))
        out = self.cv2(torch.cat(y, dim=-1))
        return out if self.gamma is None else x + self.gamma.to(out.dtype) * out


def _max_pool5(x):
    """5x5 max-pool, stride 1, SAME, on NHWC (a library call, as the JAX
    package leaves it to XLA)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 5, 1, 2).permute(0, 2, 3, 1)


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 max-pools."""

    def __init__(self, cin: int, features: int, **kw):
        super().__init__()
        c = features // 2
        self.ConvBnAct_0 = ConvBnAct(cin, c, 1, **kw)
        self.ConvBnAct_1 = ConvBnAct(4 * c, features, 1, **kw)

    def forward(self, x):
        x = self.ConvBnAct_0(x)
        p1 = _max_pool5(x)
        p2 = _max_pool5(p1)
        p3 = _max_pool5(p2)
        return self.ConvBnAct_1(torch.cat([x, p1, p2, p3], dim=-1))


def _upsample2(x):
    """Nearest-neighbour 2x upsampling of NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class DetectHead(nn.Module):
    """Decoupled anchor-free head with DFL box regression (``reg_max`` bins).
    Children are numbered as flax numbers them: per level two box
    ``ConvBnAct``s, the box ``Conv``, two class ``ConvBnAct``s, the class
    ``Conv``; a subclass's branches continue the counters."""

    def __init__(self, feats: Sequence[int], num_classes: int, reg_max: int = 16,
                 dtype=torch.float32, folded: bool = False, fused: bool = False):
        super().__init__()
        self.feats, self.num_classes, self.reg_max = tuple(feats), num_classes, reg_max
        self._kw = dict(dtype=dtype, folded=folded, fused=fused)
        self._kw1 = dict(dtype=dtype, fused=fused and folded)
        self._n_cba = self._n_conv = 0
        c2 = max(16, feats[0] // 4, reg_max * 4)
        c3 = max(feats[0], min(num_classes, 100))
        self._levels = []
        for f in feats:
            box = [self._cba(f, c2), self._cba(c2, c2), self._conv(c2, 4 * reg_max)]
            self._levels.append((box, self._class_branch(f, c3, num_classes)))
        self.reset_class_bias()

    def _class_branch(self, f: int, c3: int, num_classes: int) -> list:
        return [self._cba(f, c3), self._cba(c3, c3), self._conv(c3, num_classes)]

    @torch.no_grad()
    def reset_class_bias(self):
        """The class branches' output biases to -4.6: a prior of ~0.01."""
        for _, cls in self._levels:
            getattr(self, cls[-1]).conv.bias.fill_(-4.6)

    def _cba(self, cin, cout, kernel: int = 3, groups: int = 1):
        name = f"ConvBnAct_{self._n_cba}"
        self._n_cba += 1
        self.add_module(name, ConvBnAct(cin, cout, kernel, groups=groups, **self._kw))
        return name

    def _conv(self, cin, cout):
        name = f"Conv_{self._n_conv}"
        self._n_conv += 1
        self.add_module(name, Conv1x1(cin, cout, **self._kw1))
        return name

    def _run(self, names, x):
        for name in names:
            x = getattr(self, name)(x)
        return x

    def forward(self, feats):
        return [(self._run(box, f), self._run(cls, f)) for f, (box, cls) in zip(feats, self._levels)]


class DetectHead12(DetectHead):
    """Ultralytics' ``Detect`` with ``legacy=False`` (YOLO12): the box branch
    as v8, the class branch a depthwise 3x3 ``Conv`` (SiLU), a 1x1 ``Conv``
    to ``c3``, a depthwise 3x3, a 1x1, then the biased 1x1 to the classes.
    Per level: box ``ConvBnAct_{6i}``, ``ConvBnAct_{6i+1}``, ``Conv_{2i}``;
    class ``ConvBnAct_{6i+2..6i+5}``, ``Conv_{2i+1}``."""

    def _class_branch(self, f: int, c3: int, num_classes: int) -> list:
        return [self._cba(f, f, 3, f), self._cba(f, c3, 1), self._cba(c3, c3, 3, c3), self._cba(c3, c3, 1),
                self._conv(c3, num_classes)]


class _ExtraBranchHead(DetectHead):
    """A detect head with one more per-level branch of ``n_cba`` 3x3
    ``ConvBnAct``s of width ``c4`` and a 1x1 conv to ``n_out`` channels."""

    def _add_branch(self, c4: int, n_cba: int, n_out: int):
        self._extra = []
        for f in self.feats:
            names, cin = [], f
            for _ in range(n_cba):
                names.append(self._cba(cin, c4))
                cin = c4
            names.append(self._conv(c4, n_out))
            self._extra.append(names)

    def forward(self, feats):
        outs = super().forward(feats)
        return [(box, cls, self._run(names, f)) for f, (box, cls), names in zip(feats, outs, self._extra)]


class OBBHead(_ExtraBranchHead):
    """Adds a per-anchor rotation-angle branch; angle in (-pi/4, 3pi/4)."""

    def __init__(self, feats, num_classes, reg_max=16, **kw):
        super().__init__(feats, num_classes, reg_max, **kw)
        self._add_branch(max(feats[0] // 4, 16), 1, 1)


class PoseHead(_ExtraBranchHead):
    """Adds a per-anchor keypoint branch: ``n_kpt`` keypoints of ``(dx, dy,
    visibility logit)``."""

    def __init__(self, feats, num_classes, reg_max=16, n_kpt: int = 4, **kw):
        super().__init__(feats, num_classes, reg_max, **kw)
        self.n_kpt = n_kpt
        self._add_branch(max(feats[0] // 4, n_kpt * 3), 2, n_kpt * 3)


class SegmentHead(_ExtraBranchHead):
    """Adds per-anchor mask coefficients."""

    def __init__(self, feats, num_classes, reg_max=16, n_coeffs: int = 32, **kw):
        super().__init__(feats, num_classes, reg_max, **kw)
        self.n_coeffs = n_coeffs
        self._add_branch(max(feats[0] // 4, n_coeffs), 1, n_coeffs)


class Proto(nn.Module):
    """Prototype-mask net from the P3 feature: conv -> 2x upsample -> conv ->
    ``n_protos`` mask bases at 1/4 input resolution."""

    def __init__(self, cin: int, n_protos: int = 32, mid: int = 64,
                 dtype=torch.float32, folded: bool = False, fused: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, folded=folded, fused=fused)
        self.ConvBnAct_0 = ConvBnAct(cin, mid, 3, **kw)
        self.ConvBnAct_1 = ConvBnAct(mid, mid, 3, **kw)
        self.Conv_0 = Conv1x1(mid, n_protos, dtype=dtype, fused=fused and folded)

    def forward(self, p3):
        return self.Conv_0(self.ConvBnAct_1(_upsample2(self.ConvBnAct_0(p3))))


SCALES = {  # (depth, width) per family and variant
    "v8": {"n": (0.33, 0.25), "s": (0.33, 0.5), "m": (0.67, 0.75)},
    "v11": {"n": (0.5, 0.25), "s": (0.5, 0.5), "m": (0.5, 1.0)},
    "v12": {"n": (0.5, 0.25), "s": (0.5, 0.5), "m": (0.5, 1.0)},
}
# Ultralytics' yolo12.yaml: (depth, width, max_channels) per scale
YOLO12_SCALES = {"n": (0.50, 0.25, 1024), "s": (0.50, 0.50, 1024), "m": (0.50, 1.00, 512),
                 "l": (1.00, 1.00, 512), "x": (1.00, 1.50, 512)}


def yolo12_widths(variant: str) -> list[int]:
    """The five stage widths of a YOLO12 scale: ``ceil(min(c, max_channels)
    * width / 8) * 8``."""
    _, width, cap = YOLO12_SCALES[variant]
    return [int(math.ceil(min(c, cap) * width / 8) * 8) for c in (64, 128, 256, 512, 1024)]


class YOLO(nn.Module):
    """YOLO detector.  ``family``: ``"v8"`` (CSP backbone with C2f blocks +
    SPPF), ``"v11"`` (C3k2 blocks, SPPF + C2PSA) or ``"v12"`` (C3k2, then
    A2C2f area-attention stages: area 4 at stride 16, global at stride 32,
    and an A2C2f neck; the JAX package's reading of YOLO12); all with a
    PAN-FPN neck.  ``variant``: n/s/m;
    ``task``: detect | obb | segment | pose.  ``fold_bn``: the inference form
    with BN folded into the convs; ``fused``: run the convs in the
    hand-written kernels (needs ``fold_bn``).

    ``family="yolo12"`` is YOLO12 as Ultralytics publishes it
    (``cfg/models/12/yolo12.yaml``, ``Detect`` with ``legacy=False``),
    parameter for parameter: variants n/s/m/l/x, task detect; the same
    wiring and attribute names as ``v12`` (``b2``-``b5``, ``neck_p4``, ...,
    ``head``) over the published blocks (`A2C2f12`, `ABlock12`, `AAttn`,
    `DetectHead12`).
    """

    def __init__(self, num_classes: int = 1, variant: str = "n", task: str = "detect", family: str = "v8",
                 reg_max: int = 16, n_kpt: int = 4, compute_dtype=torch.float32, fold_bn: bool = False,
                 fused: bool = False):
        super().__init__()
        if family not in SCALES and family != "yolo12":
            raise ValueError(f"unknown family: {family}")
        if family == "yolo12" and task != "detect":
            raise ValueError(f"family 'yolo12' has the detect task only, not {task!r}")
        if fused and not fold_bn:
            raise ValueError("fused=True needs fold_bn=True: the kernels take BN-folded convs")
        self.num_classes, self.variant, self.task, self.family = num_classes, variant, task, family
        self.reg_max, self.n_kpt, self.compute_dtype, self.fold_bn, self.fused = reg_max, n_kpt, compute_dtype, fold_bn, fused
        if family == "yolo12":
            depth = YOLO12_SCALES[variant][0]
            ch = yolo12_widths(variant)
        else:
            depth, width = SCALES[family][variant]
            ch = [_make_divisible(c * width) for c in (64, 128, 256, 512, 1024)]
        self.ch = ch
        kw = dict(dtype=compute_dtype, folded=fold_bn, fused=fused)
        self.stem = ConvBnAct(3, ch[0], 3, 2, **kw)
        self.down2 = ConvBnAct(ch[0], ch[1], 3, 2, **kw)
        if family == "yolo12":
            self._yolo12_layers(variant, depth, ch, kw)
        elif family == "v8":
            n1, n2 = max(round(3 * depth), 1), max(round(6 * depth), 1)
            self.c2f_2 = C2f(ch[1], ch[1], n1, True, **kw)
            self.down3 = ConvBnAct(ch[1], ch[2], 3, 2, **kw)
            self.c2f_3 = C2f(ch[2], ch[2], n2, True, **kw)
            self.down4 = ConvBnAct(ch[2], ch[3], 3, 2, **kw)
            self.c2f_4 = C2f(ch[3], ch[3], n2, True, **kw)
            self.down5 = ConvBnAct(ch[3], ch[4], 3, 2, **kw)
            self.c2f_5 = C2f(ch[4], ch[4], n1, True, **kw)
            self.sppf = SPPF(ch[4], ch[4], **kw)
            self.neck_p4 = C2f(ch[4] + ch[3], ch[3], n1, False, **kw)
            self.neck_p3 = C2f(ch[3] + ch[2], ch[2], n1, False, **kw)
            self.pan_p4 = C2f(ch[2] + ch[3], ch[3], n1, False, **kw)
            self.pan_p5 = C2f(ch[3] + ch[4], ch[4], n1, False, **kw)
        else:  # v11 and v12: P3 is ch[3] wide
            n = max(round(2 * depth), 1)
            self.b2 = C3k2(ch[1], ch[2], n, False, 0.25, **kw)
            self.down3 = ConvBnAct(ch[2], ch[2], 3, 2, **kw)
            self.b3 = C3k2(ch[2], ch[3], n, False, 0.25, **kw)
            self.down4 = ConvBnAct(ch[3], ch[3], 3, 2, **kw)
            self.down5 = ConvBnAct(ch[3], ch[4], 3, 2, **kw)
            if family == "v11":
                self.b4 = C3k2(ch[3], ch[3], n, True, **kw)
                self.b5 = C3k2(ch[4], ch[4], n, True, **kw)
                self.sppf = SPPF(ch[4], ch[4], **kw)
                self.psa = C2PSA(ch[4], ch[4], n, **kw)
                self.neck_p4 = C3k2(ch[4] + ch[3], ch[3], n, False, **kw)
                self.neck_p3 = C3k2(ch[3] + ch[3], ch[2], n, False, **kw)
                self.pan_p4 = C3k2(ch[2] + ch[3], ch[3], n, False, **kw)
            else:
                self.b4 = A2C2f(ch[3], ch[3], 2 * n, True, 4, **kw)
                self.b5 = A2C2f(ch[4], ch[4], 2 * n, True, 1, **kw)
                self.neck_p4 = A2C2f(ch[4] + ch[3], ch[3], n, False, **kw)
                self.neck_p3 = A2C2f(ch[3] + ch[3], ch[2], n, False, **kw)
                self.pan_p4 = A2C2f(ch[2] + ch[3], ch[3], n, False, **kw)
            self.pan_p5 = C3k2(ch[3] + ch[4], ch[4], n, True, **kw)
        self.pan_d3 = ConvBnAct(ch[2], ch[2], 3, 2, **kw)
        self.pan_d4 = ConvBnAct(ch[3], ch[3], 3, 2, **kw)
        feats = ch[2:]
        if family == "yolo12":
            self.head = DetectHead12(feats, num_classes, reg_max, **kw)
        elif task == "obb":
            self.head = OBBHead(feats, num_classes, reg_max, **kw)
        elif task == "segment":
            self.head = SegmentHead(feats, num_classes, reg_max, **kw)
            self.proto = Proto(ch[2], **kw)
        elif task == "pose":
            self.head = PoseHead(feats, num_classes, reg_max, n_kpt=n_kpt, **kw)
        else:
            self.head = DetectHead(feats, num_classes, reg_max, **kw)
        self.eval()

    def _yolo12_layers(self, variant: str, depth: float, ch: list, kw: dict) -> None:
        """Layers 2-20 of ``yolo12.yaml`` but the stride-2 convs 15 and 18:
        every ``C3k2`` takes ``c3k`` at m/l/x, every ``A2C2f`` ``residual``
        and an MLP ratio of 1.2 at l/x (2.0 below)."""
        def reps(n):
            return max(round(n * depth), 1)

        big, c3k = variant in "lx", variant in "mlx"
        a2 = dict(residual=big, mlp_ratio=1.2 if big else 2.0)
        self.b2 = C3k2(ch[1], ch[2], reps(2), c3k, 0.25, 0.5, **kw)
        self.down3 = ConvBnAct(ch[2], ch[2], 3, 2, **kw)
        self.b3 = C3k2(ch[2], ch[3], reps(2), c3k, 0.25, 0.5, **kw)
        self.down4 = ConvBnAct(ch[3], ch[3], 3, 2, **kw)
        self.b4 = A2C2f12(ch[3], ch[3], reps(4), True, 4, **a2, **kw)
        self.down5 = ConvBnAct(ch[3], ch[4], 3, 2, **kw)
        self.b5 = A2C2f12(ch[4], ch[4], reps(4), True, 1, **a2, **kw)
        self.neck_p4 = A2C2f12(ch[4] + ch[3], ch[3], reps(2), False, **kw)
        self.neck_p3 = A2C2f12(ch[3] + ch[3], ch[2], reps(2), False, **kw)
        self.pan_p4 = A2C2f12(ch[2] + ch[3], ch[3], reps(2), False, **kw)
        self.pan_p5 = C3k2(ch[3] + ch[4], ch[4], reps(2), True, 0.5, 0.5, **kw)

    def train(self, mode: bool = True):
        """Training mode needs the unfolded, unfused model (the BatchNorms
        and ``F.conv2d``): the kernels and the folded convs are inference
        forms."""
        if mode and (self.fold_bn or self.fused):
            raise ValueError("training needs YOLO(fold_bn=False, fused=False)")
        return super().train(mode)

    def _backbone(self, x):
        """The (P3, P4, P5) pyramid (strides 8/16/32)."""
        x = self.down2(self.stem(x))
        if self.family == "v8":
            p3 = self.c2f_3(self.down3(self.c2f_2(x)))
            p4 = self.c2f_4(self.down4(p3))
            return p3, p4, self.sppf(self.c2f_5(self.down5(p4)))
        p3 = self.b3(self.down3(self.b2(x)))
        p4 = self.b4(self.down4(p3))
        p5 = self.b5(self.down5(p4))
        return p3, p4, (self.psa(self.sppf(p5)) if self.family == "v11" else p5)

    def forward(self, images):
        """images: ``(B, H, W, 3)`` float in [0, 1]; H, W divisible by 32.
        Returns the per-level raw head outputs, NHWC (decode with
        `decode_predictions` or `decode_topk`); for the segment task
        ``(outs, protos)``."""
        p3, p4, p5 = self._backbone(images.to(self.compute_dtype))
        n4 = self.neck_p4(torch.cat([_upsample2(p5), p4], dim=-1))
        n3 = self.neck_p3(torch.cat([_upsample2(n4), p3], dim=-1))
        o4 = self.pan_p4(torch.cat([self.pan_d3(n3), n4], dim=-1))
        o5 = self.pan_p5(torch.cat([self.pan_d4(o4), p5], dim=-1))
        outs = self.head([n3, o4, o5])
        if self.task == "segment":
            return outs, self.proto(n3)
        return outs


STRIDES = (8, 16, 32)


def make_anchors(img_size: int, strides=STRIDES, device=None):
    """Anchor-free grid centres per level: ``(A, 2)`` xy in pixels and ``(A,)`` stride."""
    pts, strs = [], []
    for s in strides:
        n = img_size // s
        yy, xx = torch.meshgrid(torch.arange(n, device=device), torch.arange(n, device=device), indexing="ij")
        pts.append(((torch.stack([xx, yy], dim=-1).reshape(-1, 2) + 0.5) * s).to(torch.float32))
        strs.append(torch.full((n * n,), float(s), dtype=torch.float32, device=device))
    return torch.cat(pts), torch.cat(strs)


def dfl_decode(box_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution-focal decode: ``(..., 4*reg_max)`` -> expected ltrb distances."""
    logits = box_logits.reshape(*box_logits.shape[:-1], 4, reg_max)
    probs = torch.softmax(logits.float(), dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=box_logits.device)
    return (probs * bins).sum(-1)


def decode_keypoints(raw: torch.Tensor, anchors: torch.Tensor, strides: torch.Tensor) -> torch.Tensor:
    """Raw pose-head output ``(..., A, K*3)`` -> ``(..., A, K, 3)`` decoded
    ``[x_px, y_px, visibility]``: ``xy = raw*2*stride + (anchor - stride/2)``,
    visibility through a sigmoid.  ``anchors (..., A, 2)`` and ``strides
    (..., A)`` broadcast against ``raw``'s leading axes."""
    kpts = raw.reshape(*raw.shape[:-1], raw.shape[-1] // 3, 3).float()
    base = anchors - 0.5 * strides[..., None]
    xy = kpts[..., :2] * 2.0 * strides[..., None, None] + base[..., None, :]
    return torch.cat([xy, torch.sigmoid(kpts[..., 2:3])], dim=-1)


def _decode_extra(raw: torch.Tensor, task, anc, stri):
    """The task head's extra output on flat rows ``(B, N, E)``."""
    if task == "pose":
        return decode_keypoints(raw, anc, stri)
    if task == "obb" or (task is None and raw.shape[-1] == 1):
        # explicit task wins; the channel count is only the task-less fallback
        return (torch.sigmoid(raw[..., 0].float()) - 0.25) * math.pi
    return raw.float()  # segment: mask coefficients


def decode_predictions(outs, img_size: int, reg_max: int = 16, task: str | None = None):
    """Head outputs -> flat per-anchor ``(boxes_xyxy, scores, extras)``:
    boxes in pixels, scores per-class sigmoid probabilities ``(B, A, C)``,
    extras by head (OBB angle ``(B, A)``, mask coefficients ``(B, A, P)``,
    pose keypoints ``(B, A, K, 3)``, detect ``None``)."""
    anchors, strides = make_anchors(img_size, device=outs[0][0].device)
    boxes, scores, extras_l = [], [], []
    a0 = 0
    for out in outs:
        box_l, cls_l = out[0], out[1]
        b, h, w, _ = box_l.shape
        n = h * w
        ltrb = dfl_decode(box_l.reshape(b, n, 4 * reg_max), reg_max)
        anc, stri = anchors[a0:a0 + n], strides[a0:a0 + n]
        a0 += n
        xy1 = anc[None] - ltrb[..., :2] * stri[None, :, None]
        xy2 = anc[None] + ltrb[..., 2:] * stri[None, :, None]
        boxes.append(torch.cat([xy1, xy2], dim=-1))
        scores.append(torch.sigmoid(cls_l.reshape(b, n, -1).float()))
        if len(out) == 3:
            extras_l.append(_decode_extra(out[2].reshape(b, n, -1), task, anc, stri))
    extras = torch.cat(extras_l, dim=1) if extras_l else None
    return torch.cat(boxes, dim=1), torch.cat(scores, dim=1), extras


def decode_topk(outs, img_size: int, k: int, reg_max: int = 16, task: str | None = None):
    """Head decode that selects the top-K candidates before the per-anchor
    decode: ranks in float32 sigmoid space (ties to the lower anchor index,
    as ``jax.lax.top_k`` does), then runs the DFL softmax, the box assembly
    and the task head's extra decode on the K winners only.

    Returns per-image score-sorted ``(boxes_xyxy (B, K, 4), scores (B, K),
    classes (B, K) int32, idx (B, K) int32, extras)``; ``idx`` indexes the
    flat anchor axis in `decode_predictions` order and ``extras`` rows are
    aligned with the candidate rows."""
    dev = outs[0][0].device
    anchors, strides = make_anchors(img_size, device=dev)
    cls_flat, box_flat, extra_flat = [], [], []
    for out in outs:
        b, h, w, _ = out[0].shape
        box_flat.append(out[0].reshape(b, h * w, 4 * reg_max))
        cls_flat.append(out[1].reshape(b, h * w, -1))
        if len(out) == 3:
            extra_flat.append(out[2].reshape(b, h * w, -1))
    cls_flat, box_flat = torch.cat(cls_flat, dim=1), torch.cat(box_flat, dim=1)

    probs = torch.sigmoid(cls_flat.float())
    conf, cls_idx = probs.max(dim=-1)  # first index on ties
    order = torch.sort(conf, dim=1, descending=True, stable=True).indices[:, :k]
    top_conf = torch.gather(conf, 1, order)

    def rows(t):
        return torch.gather(t, 1, order[..., None].expand(-1, -1, t.shape[-1]))

    ltrb = dfl_decode(rows(box_flat), reg_max)
    anc, stri = anchors[order], strides[order]
    boxes = torch.cat([anc - ltrb[..., :2] * stri[..., None], anc + ltrb[..., 2:] * stri[..., None]], dim=-1)
    classes = torch.gather(cls_idx, 1, order).to(torch.int32)
    extras = _decode_extra(rows(torch.cat(extra_flat, dim=1)), task, anc, stri) if extra_flat else None
    return boxes, top_conf, classes, order.to(torch.int32), extras


def fold_batchnorm(params: dict, batch_stats: dict, eps: float = BN_EPS):
    """Absorb every ConvBnAct's BatchNorm affine into its conv kernel and
    bias, on a flax-shaped tree of numpy arrays: ``K' = K * s`` and ``b' =
    bias - mean * s`` with ``s = scale / sqrt(var + eps)``.  Only scopes that
    are a ConvBnAct (exactly ``{Conv_0, BatchNorm_0}``) fold.  Returns
    ``(params, batch_stats)`` shaped for ``YOLO(fold_bn=True)``."""

    def walk(p, bs):
        if not isinstance(p, dict):
            return p, bs
        if set(p.keys()) == {"Conv_0", "BatchNorm_0"} and "kernel" in p["Conv_0"]:
            k = np.asarray(p["Conv_0"]["kernel"], np.float32)
            g = np.asarray(p["BatchNorm_0"]["scale"], np.float32)
            b = np.asarray(p["BatchNorm_0"]["bias"], np.float32)
            mean = np.asarray(bs["BatchNorm_0"]["mean"], np.float32)
            var = np.asarray(bs["BatchNorm_0"]["var"], np.float32)
            s = g / np.sqrt(var + np.float32(eps))
            return {"Conv_0": {"kernel": k * s, "bias": b - mean * s}}, None
        new_p, new_bs = {}, {}
        for key, sub in p.items():
            fp, fbs = walk(sub, bs.get(key, {}) if isinstance(bs, dict) else {})
            new_p[key] = fp
            if fbs:
                new_bs[key] = fbs
        if isinstance(bs, dict):
            for key, sub in bs.items():
                if key not in p:
                    new_bs[key] = sub
        return new_p, (new_bs or None)

    fp, fbs = walk(params, batch_stats or {})
    return fp, (fbs or {})
