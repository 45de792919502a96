"""Layers with flax's semantics, for the port's models.

flax keeps a module's parameters in fp32 and computes in its ``dtype``:
``Dense``, ``Conv`` and ``Embed`` cast their input and parameters to it
before the product; ``LayerNorm``, ``GroupNorm`` and ``BatchNorm`` take
their statistics in fp32. The layers here do the same, so a model built
from them holds fp32 parameters (what an optimizer updates) and runs in
the compute type its config names, as the JAX package's BERT, ResNet and
UNet do under their train steps.

Images are NHWC at a model's edges, as in the JAX package; inside, the
convolutions see the NCHW view of that memory (``permute``), which is
PyTorch's ``channels_last`` layout, so no copy is made. ``padding="SAME"``
is XLA's: the output is ``ceil(in / stride)`` and the total padding is
split with the smaller half first, so a stride-2 3x3 convolution over an
even size pads ``(0, 1)``, not ``(1, 1)``.

flax defaults that differ from torch's: ``LayerNorm`` and ``GroupNorm``
take epsilon 1e-6, and ``GroupNorm``'s and ``BatchNorm``'s statistics
are flax's one-pass ``E[x^2] - E[x]^2``, clipped at zero.
``BatchNorm(momentum=0.9)`` keeps ``ra = 0.9 ra + 0.1 batch`` with the
biased batch variance (torch's module would keep the unbiased one), so
:class:`BatchNorm` writes its own update.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

FLAX_NORM_EPS = 1e-6


def _fast_stats(x32, dims):
    """flax's ``_compute_stats``: mean and ``max(0, E[x^2] - E[x]^2)``."""
    mean = x32.mean(dims, keepdim=True)
    var = torch.clamp_min((x32 * x32).mean(dims, keepdim=True)
                          - mean * mean, 0.0)
    return mean, var


class LayerNorm(nn.Module):
    """``nn.LayerNorm(dtype=float32)``: statistics, scale and shift in
    fp32 over the last axis; returns fp32. One fused ``F.layer_norm``
    (its two-pass variance is within fp32 rounding of flax's one-pass
    one at these scales; a decode pass runs 25 of these in GPT-2)."""

    def __init__(self, dim: int, eps: float = FLAX_NORM_EPS) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape,
                            self.weight.float(), self.bias.float(), self.eps)


class GroupNorm(nn.Module):
    """``nn.GroupNorm(dtype=float32)`` over NCHW: statistics over each
    group's channels and all positions, in fp32; returns fp32."""

    def __init__(self, groups: int, channels: int,
                 eps: float = FLAX_NORM_EPS) -> None:
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c, h, w = x.shape
        g = x.float().reshape(b, self.groups, c // self.groups, h, w)
        mean, var = _fast_stats(g, (2, 3, 4))
        y = ((g - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, h, w)
        return (y * self.weight.float()[:, None, None]
                + self.bias.float()[:, None, None])


class BatchNorm(nn.Module):
    """``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=...)`` over NCHW.

    In training mode it normalises with the batch's statistics (fp32,
    biased variance) and updates the running ``mean``/``var`` buffers
    in place as ``m * ra + (1 - m) * batch``; in eval mode it uses the
    buffers. The result is computed in fp32 and cast to the layer's
    compute type, as flax's ``_normalize`` does."""

    def __init__(self, channels: int, dtype: torch.dtype,
                 momentum: float = 0.9, eps: float = 1e-5) -> None:
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        x32 = x.float()
        if self.training:
            mean, var = _fast_stats(x32, (0, 2, 3))
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_((1 - m) * mean.flatten())
                self.var.mul_(m).add_((1 - m) * var.flatten())
        else:
            mean = self.mean[None, :, None, None]
            var = self.var[None, :, None, None]
        mul = torch.rsqrt(var + self.eps) * self.weight.float()[:, None, None]
        y = (x32 - mean) * mul + self.bias.float()[:, None, None]
        return y.to(self.dtype)


class Dense(nn.Linear):
    """``nn.Dense(dtype=...)``: fp32 parameters, input, kernel and bias
    cast to the compute type for the product."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, bias: bool = True) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class Embed(nn.Module):
    """``nn.Embed(dtype=...)``: the fp32 table cast to the compute type,
    then gathered."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, dim))

    def forward(self, ids):
        return F.embedding(ids, self.weight.to(self.compute_dtype))


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial axis: ``(lo, hi)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """``nn.Conv(features, (k, k), strides, padding, dtype=...)`` over the
    NCHW view: fp32 parameters (``weight [out, in, k, k]``, flax's
    ``[k, k, in, out]`` transposed), input, kernel and bias cast to the
    compute type. ``padding`` is ``"SAME"`` or a symmetric int."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 dtype: torch.dtype, stride: int = 1,
                 padding: str | int = "SAME", bias: bool = True) -> None:
        super().__init__(in_ch, out_ch, kernel, stride=stride, bias=bias)
        self.compute_dtype = dtype
        self.same = padding == "SAME"
        self.pad = 0 if self.same else int(padding)

    def forward(self, x):
        dt = self.compute_dtype
        k, s = self.kernel_size[0], self.stride[0]
        pad = self.pad
        x = x.to(dt)
        if self.same:
            (top, bottom), (left, right) = (same_pads(n, k, s)
                                            for n in x.shape[2:])
            if top == bottom and left == right == top:
                pad = top
            else:
                x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt),
                        s, pad)


# flax's lecun_normal: a unit normal truncated to [-2, 2] has this std
TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int, gen) -> None:
    """flax's ``lecun_normal`` into ``t`` (drawn in fp32, then cast):
    a normal of variance ``1 / fan_in`` truncated at two deviations."""
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    std = 1.0 / math.sqrt(fan_in) / TRUNC_STD
    nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=gen)
    t.copy_(draw)
