"""Layer blocks of the detector families, NCHW.

Counterpart of ``yoloseries_tpu/nn/layers.py``. Submodule names follow the
reference's ``state_dict`` keys (``conv``/``bn``, ``cba1..3``,
``blocks.N.conv_bn_act_1/2``; C2f's ``conv1``/``conv2``/``block.N``) so a
port ``state_dict`` converts to the JAX trees by name; the depthwise pair is
``dw``/``pw`` and ``Focus`` holds its conv as ``conv``, as in the JAX trees.

BatchNorm conventions: eps 1e-3 (1e-5 for ``BottleneckCSP``'s fuse BN),
torch momentum 0.03 (flax 0.97), unbiased running variance (torch's own
accumulation), and eval mode computed as ``x * mul + shift`` with
``mul = weight * rsqrt(var + eps)``, the same arithmetic as the JAX
``TorchBatchNorm``.

Compute dtype: parameters and BN statistics stay f32 and the activations
keep the dtype they arrive in (the model casts its input once). A conv casts
its kernel to the input's dtype. BN takes its batch statistics in f32
(one-pass variance) and returns its affine in f32; the block applies its
activation and rounds once to the compute dtype: the JAX package's
``dtype=bfloat16`` arithmetic as one XLA fusion computes it when it may keep
excess precision. XLA on the CPU, and JAX run op by op, round after every op
instead (the affine's multiply and add, each op of SiLU); on the card that
rounding matches fewer of the f32 model's detections
(``scripts/torch_bf16_rounding.py``; ROADMAP section C).

Rematerialization: a block run under ``torch.utils.checkpoint`` with
``context_fn=remat_context`` runs its forward again in the backward; BN
then normalizes by the same batch statistics but leaves the running ones
alone, so they move once per forward, as under ``flax.linen.remat``.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "BatchNorm",
    "Conv2d",
    "ConvBnAct",
    "DWConvBnAct",
    "BasicBottleneck",
    "BottleneckCSP",
    "C2f",
    "ConciseBottleneck",
    "C3BottleneckCSP",
    "Focus",
    "SPP",
    "FastSPP",
    "CSPCSPP",
    "RepConv",
    "ImplicitAdd",
    "ImplicitMul",
    "Scale",
    "GroupNorm",
    "DetectHead",
    "detect_bias_init",
    "remat_context",
    "upsample2x",
    "max_pool_same",
]

# set while torch.utils.checkpoint recomputes a block in the backward
_RECOMPUTING = contextvars.ContextVar("yst_recomputing", default=False)


@contextlib.contextmanager
def _recomputing():
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def remat_context():
    """``context_fn`` of ``torch.utils.checkpoint``: nothing around the
    first forward, the recompute flagged so BN leaves its running stats."""
    return contextlib.nullcontext(), _recomputing()


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
    arithmetic (``x * mul + shift``). In training, f32 input takes torch's
    fused kernel (two-pass batch variance), low-precision input the
    one-pass form of the JAX ``TorchBatchNorm`` (``_one_pass``)."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__(channels, eps=eps, momentum=0.03)

    def _affine(self, x, mean, var):
        """``x * mul + shift`` with f32 ``mul``/``shift``: f32 out for any x."""
        mul = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * mul
        return x * mul[None, :, None, None] + shift[None, :, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self._affine(x, self.running_mean, self.running_var)
        recompute = _RECOMPUTING.get()
        if x.dtype != torch.float32:
            return self._one_pass(x, recompute)
        if not recompute:
            return super().forward(x)
        # the same kernel on copies of the running stats: the recompute
        # sees the first forward's output and the stats stay put
        return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                            self.weight, self.bias, True, self.momentum, self.eps)

    def _one_pass(self, x: torch.Tensor, recompute: bool) -> torch.Tensor:
        """Training: batch statistics in f32 (one-pass variance, as the JAX
        TorchBatchNorm), the affine in f32."""
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
        if not recompute:
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var * (n / max(n - 1, 1)), self.momentum)
                self.num_batches_tracked.add_(1)
        return self._affine(x, mean, var)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose kernel (and bias) is cast to the input's dtype:
    f32 parameters, bf16 convolutions under a bf16 input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvBnAct(nn.Module):
    """Conv (no bias) + BatchNorm(eps 1e-3) + SiLU; ``groups`` as in
    ``nn.Conv2d`` (``groups=in_channels``: depthwise)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1,
                 stride: int = 1, padding: int | None = None, act: bool = True,
                 groups: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        pad = autopad(kernel, padding)
        self.conv = Conv2d(in_channels, out_channels, kernel, stride, pad,
                           groups=groups, bias=False)
        kaiming_fan_out_(self.conv.weight, generator)
        self.bn = BatchNorm(out_channels)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        x = self.bn(y)
        return (F.silu(x) if self.act else x).to(y.dtype)


class DWConvBnAct(nn.Module):
    """Depthwise ``ConvBnAct`` (``dw``) then a pointwise one (``pw``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        self.dw = ConvBnAct(in_channels, in_channels, kernel, stride, groups=in_channels,
                            generator=generator)
        self.pw = ConvBnAct(in_channels, out_channels, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))


class BasicBottleneck(nn.Module):
    """``kernels[0]`` -> ``kernels[1]`` conv pair (default 1x1 -> 3x3) with an
    optional residual; its convs are ``NAMES``."""

    NAMES = ("conv_bn_act_1", "conv_bn_act_2")

    def __init__(self, in_channels: int, out_channels: int, shortcut: bool = True,
                 expand_ratio: float = 0.5, kernels: tuple = (1, 3),
                 generator: torch.Generator | None = None):
        super().__init__()
        mid = int(in_channels * expand_ratio)
        first, second = self.NAMES
        setattr(self, first, ConvBnAct(in_channels, mid, kernels[0], generator=generator))
        setattr(self, second, ConvBnAct(mid, out_channels, kernels[1], generator=generator))
        self.residual = shortcut and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first, second = self.NAMES
        y = getattr(self, second)(getattr(self, first)(x))
        return y + x if self.residual else y


class ConciseBottleneck(BasicBottleneck):
    """C2f's inner block: two 3x3 convs at the input width, named ``conv1`` /
    ``conv2`` as in the reference's ConciseBottleneck."""

    NAMES = ("conv1", "conv2")

    def __init__(self, channels: int, shortcut: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__(channels, channels, shortcut, expand_ratio=1.0, kernels=(3, 3),
                         generator=generator)


class C2f(nn.Module):
    """YOLOv8's concise CSP block: ``conv1`` (1x1) split in two halves, a
    chain of ``num_blocks`` ``ConciseBottleneck``s on the second, every
    part concatenated, ``conv2`` (1x1)."""

    def __init__(self, in_channels: int, out_channels: int, shortcut: bool = False,
                 num_blocks: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        mid = out_channels // 2
        self.mid = mid
        self.conv1 = ConvBnAct(in_channels, 2 * mid, 1, generator=generator)
        self.block = nn.ModuleList(ConciseBottleneck(mid, shortcut, generator=generator)
                                   for _ in range(num_blocks))
        self.conv2 = ConvBnAct((2 + num_blocks) * mid, out_channels, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = list(self.conv1(x).split(self.mid, dim=1))
        for block in self.block:
            parts.append(block(parts[-1]))
        return self.conv2(torch.cat(parts, dim=1))


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


class BottleneckCSP(nn.Module):
    """Plain CSP block: a raw 1x1 side conv, ``cba1`` and the bottlenecks
    then a raw 1x1 ``mid_conv``, BN (eps 1e-5) over the concat, LeakyReLU
    0.1, then ``cba2``. JAX names ``cv_side``/``cv_mid``/``cv1``/``cv2``."""

    def __init__(self, in_channels: int, out_channels: int, shortcut: bool = True,
                 num_blocks: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        mid = out_channels // 2
        self.side_conv = Conv2d(in_channels, mid, 1, bias=False)
        kaiming_fan_out_(self.side_conv.weight, generator)
        self.cba1 = ConvBnAct(in_channels, mid, 1, padding=0, generator=generator)
        self.blocks = nn.ModuleList(
            BasicBottleneck(mid, mid, shortcut, expand_ratio=1.0, generator=generator)
            for _ in range(num_blocks)
        )
        self.mid_conv = Conv2d(mid, mid, 1, bias=False)
        kaiming_fan_out_(self.mid_conv.weight, generator)
        self.bn = BatchNorm(2 * mid, eps=1e-5)
        self.cba2 = ConvBnAct(2 * mid, out_channels, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y2 = self.side_conv(x)
        y1 = self.cba1(x)
        for block in self.blocks:
            y1 = block(y1)
        y = torch.cat([self.mid_conv(y1), y2], dim=1)
        return self.cba2(F.leaky_relu(self.bn(y), 0.1).to(y.dtype))


class Focus(nn.Module):
    """Space-to-depth stem: the four pixel phases concatenated in the order
    (0, 0), (1, 0), (0, 1), (1, 1) as (row, column) offsets, then ``conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1,
                 stride: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        self.conv = ConvBnAct(4 * in_channels, out_channels, kernel, stride,
                              generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, :, ::2, ::2], x[:, :, 1::2, ::2], x[:, :, ::2, 1::2],
                       x[:, :, 1::2, 1::2]], dim=1)
        return self.conv(x)


class SPP(nn.Module):
    """Parallel 5/9/13 max-pool pyramid."""

    def __init__(self, in_channels: int, out_channels: int, kernels=(5, 9, 13),
                 generator: torch.Generator | None = None):
        super().__init__()
        mid = in_channels // 2
        self.cba1 = ConvBnAct(in_channels, mid, 1, padding=0, generator=generator)
        self.cba2 = ConvBnAct((len(kernels) + 1) * mid, out_channels, 1, generator=generator)
        self.kernels = tuple(kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cba1(x)
        return self.cba2(torch.cat([x] + [max_pool_same(x, k) for k in self.kernels], dim=1))


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


class CSPCSPP(nn.Module):
    """YOLOv7's CSP-wrapped 5/9/13 SPP at half the input width; convs
    ``cba1..cba7`` as in the reference (JAX ``cv1..cv7``)."""

    def __init__(self, in_channels: int, out_channels: int, kernels=(5, 9, 13),
                 generator: torch.Generator | None = None):
        super().__init__()
        mid, g = in_channels // 2, generator
        self.cba1 = ConvBnAct(in_channels, mid, 1, padding=0, generator=g)
        self.cba3 = ConvBnAct(mid, mid, 3, generator=g)
        self.cba4 = ConvBnAct(mid, mid, 1, padding=0, generator=g)
        self.cba5 = ConvBnAct((len(kernels) + 1) * mid, mid, 1, padding=0, generator=g)
        self.cba6 = ConvBnAct(mid, mid, 3, generator=g)
        self.cba2 = ConvBnAct(in_channels, mid, 1, padding=0, generator=g)
        self.cba7 = ConvBnAct(2 * mid, out_channels, 1, padding=0, generator=g)
        self.kernels = tuple(kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p1 = self.cba4(self.cba3(self.cba1(x)))
        p1 = torch.cat([p1] + [max_pool_same(p1, k) for k in self.kernels], dim=1)
        p1 = self.cba6(self.cba5(p1))
        return self.cba7(torch.cat([p1, self.cba2(x)], dim=1))


class RepConv(nn.Module):
    """RepVGG conv with SiLU. Training form: ``rbr_dense`` (k x k conv + BN),
    ``rbr_1x1`` (1x1 conv + BN) and, when in == out and stride 1,
    ``rbr_identity`` (BN), summed. ``deploy=True``: one biased k x k conv
    ``rbr_reparam`` whose weights ``nn/deploy.py::fold_repconv`` makes from
    the three branches."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True, deploy: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        pad = kernel // 2
        self.act, self.deploy = act, deploy
        if deploy:
            self.rbr_reparam = Conv2d(in_channels, out_channels, kernel, stride, pad,
                                      groups=groups)
            kaiming_fan_out_(self.rbr_reparam.weight, generator)
            nn.init.zeros_(self.rbr_reparam.bias)
            return
        dense = Conv2d(in_channels, out_channels, kernel, stride, pad, groups=groups, bias=False)
        one = Conv2d(in_channels, out_channels, 1, stride, 0, groups=groups, bias=False)
        kaiming_fan_out_(dense.weight, generator)
        kaiming_fan_out_(one.weight, generator)
        self.rbr_dense = nn.Sequential(dense, BatchNorm(out_channels))
        self.rbr_1x1 = nn.Sequential(one, BatchNorm(out_channels))
        self.rbr_identity = (BatchNorm(in_channels)
                             if in_channels == out_channels and stride == 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            y = self.rbr_reparam(x)
        else:  # the BNs return f32: one rounding after the activation
            y = self.rbr_dense(x) + self.rbr_1x1(x)
            if self.rbr_identity is not None:
                y = y + self.rbr_identity(x)
        return (F.silu(y) if self.act else y).to(x.dtype)


class ImplicitAdd(nn.Module):
    """YOLOR's learned additive prior: an f32 (1, C, 1, 1) parameter
    ``implicit`` drawn from N(0, 0.02)."""

    def __init__(self, channels: int, generator: torch.Generator | None = None):
        super().__init__()
        self.implicit = nn.Parameter(torch.empty(1, channels, 1, 1))
        with torch.no_grad():
            self.implicit.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.implicit.to(x.dtype)


class ImplicitMul(nn.Module):
    """YOLOR's learned multiplicative prior: ``implicit`` drawn from
    1 + N(0, 0.02)."""

    def __init__(self, channels: int, generator: torch.Generator | None = None):
        super().__init__()
        self.implicit = nn.Parameter(torch.empty(1, channels, 1, 1))
        with torch.no_grad():
            self.implicit.normal_(0.0, 0.02, generator=generator).add_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.implicit.to(x.dtype)


class Scale(nn.Module):
    """A learnable f32 scalar ``scale`` (FCOS's per-level regression scale)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` (32 groups, eps 1e-5, as the JAX package sets them)
    computed in f32 and returned in the input's dtype."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5):
        super().__init__(groups, channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


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
            conv = Conv2d(ch, out, 1)
            kaiming_fan_out_(conv.weight, generator)
            with torch.no_grad():
                conv.bias.copy_(detect_bias_init(s, num_class, num_anchor))
            setattr(self, name, conv)

    def forward(self, xs):
        return [getattr(self, n)(x) for n, x in zip(self.NAMES, xs)]
