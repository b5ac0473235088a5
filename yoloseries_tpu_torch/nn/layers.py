"""Layer blocks of the YOLOv5 s/m/l/x graph, NCHW.

Counterpart of ``yoloseries_tpu/nn/layers.py``. Submodule names follow the
reference's ``state_dict`` keys (``conv``/``bn``, ``cba1..3``,
``blocks.N.conv_bn_act_1/2``) so a port ``state_dict`` converts to the JAX
trees by name.

BatchNorm conventions: eps 1e-3, torch momentum 0.03 (flax 0.97), unbiased
running variance (torch's own accumulation), and eval mode computed as
``x * mul + shift`` with ``mul = weight * rsqrt(var + eps)``, the same
arithmetic as the JAX ``TorchBatchNorm``.

The depthwise and plain-BottleneckCSP blocks (``DWConvBnAct``, ``Focus``,
``SPP``, ``BottleneckCSP``) are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "BatchNorm",
    "ConvBnAct",
    "BasicBottleneck",
    "C3BottleneckCSP",
    "FastSPP",
    "DetectHead",
    "detect_bias_init",
    "upsample2x",
    "max_pool_same",
]


def autopad(kernel: int, padding: int | None) -> int:
    return kernel // 2 if padding is None else padding


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NCHW: each pixel becomes a 2x2 block."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(b, c, 2 * h, 2 * w)


def max_pool_same(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Stride-1 max pool with SAME padding; the frame counts as -inf."""
    return F.max_pool2d(x, kernel, stride=1, padding=kernel // 2)


def kaiming_fan_out_(weight: torch.Tensor, generator: torch.Generator | None):
    """N(0, 2 / fan_out) with fan_out = out * kh * kw, the JAX package's
    ``variance_scaling(2.0, "fan_out", "normal")``."""
    fan_out = weight.shape[0] * weight.shape[2] * weight.shape[3]
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with eps 1e-3, momentum 0.03 and the reference's eval
    arithmetic (``x * mul + shift``)."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__(channels, eps=eps, momentum=0.03)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * mul
        return x * mul[None, :, None, None] + shift[None, :, None, None]


class ConvBnAct(nn.Module):
    """Conv (no bias) + BatchNorm(eps 1e-3) + SiLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1,
                 stride: int = 1, padding: int | None = None, act: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        pad = autopad(kernel, padding)
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride, pad,
                              bias=False)
        kaiming_fan_out_(self.conv.weight, generator)
        self.bn = BatchNorm(out_channels)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class BasicBottleneck(nn.Module):
    """1x1 -> 3x3 conv pair with an optional residual."""

    def __init__(self, in_channels: int, out_channels: int, shortcut: bool = True,
                 expand_ratio: float = 0.5,
                 generator: torch.Generator | None = None):
        super().__init__()
        mid = int(in_channels * expand_ratio)
        self.conv_bn_act_1 = ConvBnAct(in_channels, mid, 1, generator=generator)
        self.conv_bn_act_2 = ConvBnAct(mid, out_channels, 3, generator=generator)
        self.residual = shortcut and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_bn_act_2(self.conv_bn_act_1(x))
        return y + x if self.residual else y


class C3BottleneckCSP(nn.Module):
    """CSP block with three convs."""

    def __init__(self, in_channels: int, out_channels: int, shortcut: bool = True,
                 num_blocks: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        mid = out_channels // 2
        self.cba1 = ConvBnAct(in_channels, mid, 1, generator=generator)
        self.blocks = nn.ModuleList(
            BasicBottleneck(mid, mid, shortcut, expand_ratio=1.0, generator=generator)
            for _ in range(num_blocks)
        )
        self.cba2 = ConvBnAct(in_channels, mid, 1, generator=generator)
        self.cba3 = ConvBnAct(2 * mid, out_channels, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.cba1(x)
        for block in self.blocks:
            y1 = block(y1)
        y2 = self.cba2(x)
        return self.cba3(torch.cat([y1, y2], dim=1))


class FastSPP(nn.Module):
    """Chained 5x5 max-pool SPP."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 5,
                 generator: torch.Generator | None = None):
        super().__init__()
        mid = in_channels // 2
        self.cba1 = ConvBnAct(in_channels, mid, 1, padding=0, generator=generator)
        self.cba2 = ConvBnAct(4 * mid, out_channels, 1, generator=generator)
        self.kernel = kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cba1(x)
        x2 = max_pool_same(x, self.kernel)
        x3 = max_pool_same(x2, self.kernel)
        x4 = max_pool_same(x3, self.kernel)
        return self.cba2(torch.cat([x, x2, x3, x4], dim=1))


def detect_bias_init(stride: float, num_class: int, num_anchor: int) -> torch.Tensor:
    """Detection-head bias prior, (A * (5 + nc),): obj log(8 / (512/s)^2),
    cls log(0.6 / (nc - 0.99)), box 0."""
    b = torch.zeros(num_anchor, 5 + num_class)
    b[:, 4] = torch.log(torch.tensor(8.0 / (512.0 / stride) ** 2))
    b[:, 5:] = torch.log(torch.tensor(0.6 / (num_class - 0.99)))
    return b.reshape(-1)


class DetectHead(nn.Module):
    """One biased 1x1 conv per scale. Returns (B, A*(5+nc), H, W) raw maps;
    reshaping and activation are the decoder's business."""

    NAMES = ("detect_small", "detect_mid", "detect_large")

    def __init__(self, in_channels, num_class: int, num_anchor: int = 3,
                 strides=(8, 16, 32), generator: torch.Generator | None = None):
        super().__init__()
        out = num_anchor * (5 + num_class)
        for name, ch, s in zip(self.NAMES, in_channels, strides):
            conv = nn.Conv2d(ch, out, 1)
            kaiming_fan_out_(conv.weight, generator)
            with torch.no_grad():
                conv.bias.copy_(detect_bias_init(s, num_class, num_anchor))
            setattr(self, name, conv)

    def forward(self, xs):
        return [getattr(self, n)(x) for n, x in zip(self.NAMES, xs)]
