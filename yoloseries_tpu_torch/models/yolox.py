"""YOLOX family: the YOLOv5 CSP trunk or a DarkNet backbone, then a
decoupled anchor-free head per scale.

Counterpart of ``yoloseries_tpu/models/yolox.py``:

* ``YOLOX`` (yolox_s/m/l): the port's ``CSPTrunk`` unchanged (with
  ``dtype``, ``remat`` and ``s2d_stem``), then one ``DecoupledHead`` per
  PAN map: a 3x3 stem, a cls tower ending in a 1x1 cls conv (nc), and a
  reg tower feeding a 1x1 reg conv (4) and a 1x1 cof conv (1). The prior
  bias -log((1 - 0.01) / 0.01) goes on cls and reg; cof keeps a zero bias.
* ``YOLOXDarknet`` (yolox_darknet21/53): a plain residual DarkNet, an SPP
  bridge on the /32 map and a top-down neck, heads with two conv blocks
  per tower.

Names: ``YOLOX`` carries the reference's ``state_dict`` keys (the trunk
under ``neck.``, heads ``detect.pred_{small,middle,large}`` with ``stem``,
``cls.0`` the cls tower, ``cls.1`` the cls conv, ``conv.0`` the reg tower,
``reg`` and ``cof``), so ``convert_yolox_state_dict`` of the JAX package
reads it. The reference converter has no DarkNet; ``YOLOXDarknet`` names
its backbone and neck after the JAX module paths (``backbone.s{i}_down``,
``backbone.s{i}_b{j}``, ``bridge1``..``bridge4``, ``spp``, ``lat5``,
``fuse4``, ``lat4``, ``fuse3``) and its heads as ``YOLOX``'s, two blocks
per tower (``cls.0``, ``cls.1``, then the conv as ``cls.2``).

Input (B, 3, H, W) in [0, 1], H and W multiples of 32. Returns three raw
maps (B, A*(5+nc), H/s, W/s) at s = 8, 16, 32 with A = 1 and the channel
order [x, y, w, h, cof, cls...]; the decoder reads the flat index
((y*W + x)*A + a) as the JAX package's NHWC maps do. Decode:
xy = (p + grid) * s, wh = exp(p) * s.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..nn.layers import SPP, BasicBottleneck, Conv2d, ConvBnAct, kaiming_fan_out_, upsample2x
from .yolov5 import YOLOV5_SIZES, CSPTrunk, YOLOv5Spec

__all__ = ["DarknetBackbone", "DecoupledHead", "YOLOX", "YOLOXDarknet", "YOLOX_SIZES",
           "YOLOXSpec"]


@dataclasses.dataclass(frozen=True)
class YOLOXSpec:
    trunk: YOLOv5Spec
    head_width: int  # decoupled-head mid channels
    tower_depth: int = 1  # conv blocks per cls / reg tower


YOLOX_SIZES: dict[str, YOLOXSpec] = {
    "s": YOLOXSpec(YOLOV5_SIZES["s"], 128, 1),
    "m": YOLOXSpec(YOLOV5_SIZES["m"], 192, 1),
    "l": YOLOXSpec(YOLOV5_SIZES["l"], 256, 1),
}

HEAD_NAMES = ("pred_small", "pred_middle", "pred_large")
PRIOR_PROB = 0.01  # the cls and reg biases start at -log((1 - p) / p)


def _head_conv(cin: int, cout: int, generator, bias: float = 0.0) -> Conv2d:
    conv = Conv2d(cin, cout, 1)
    kaiming_fan_out_(conv.weight, generator)
    with torch.no_grad():
        conv.bias.fill_(bias)
    return conv


class DecoupledHead(nn.Module):
    """One scale's decoupled head; output (B, A*(5+nc), H, W)."""

    def __init__(self, in_channels: int, num_class: int, mid_channels: int,
                 num_anchor: int = 1, tower_depth: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        g, mid = generator, mid_channels
        prior = -math.log((1 - PRIOR_PROB) / PRIOR_PROB)
        self.num_class, self.num_anchor = num_class, num_anchor
        self.stem = ConvBnAct(in_channels, mid, 3, generator=g)
        self.cls = nn.Sequential(*[ConvBnAct(mid, mid, 3, generator=g)
                                   for _ in range(tower_depth)],
                                 _head_conv(mid, num_anchor * num_class, g, prior))
        self.conv = nn.Sequential(*[ConvBnAct(mid, mid, 3, generator=g)
                                    for _ in range(tower_depth)])
        self.reg = _head_conv(mid, num_anchor * 4, g, prior)
        self.cof = _head_conv(mid, num_anchor, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        f = self.conv(x)
        b, _, h, w = x.shape
        na = self.num_anchor
        out = torch.cat([self.reg(f).view(b, na, 4, h, w), self.cof(f).view(b, na, 1, h, w),
                         self.cls(x).view(b, na, self.num_class, h, w)], dim=2)
        return out.view(b, na * (5 + self.num_class), h, w)


class _Detect(nn.Module):
    def __init__(self, in_channels, num_class, head_width, num_anchor, tower_depth, generator):
        super().__init__()
        for name, ch in zip(HEAD_NAMES, in_channels):
            setattr(self, name, DecoupledHead(ch, num_class, head_width, num_anchor,
                                              tower_depth, generator=generator))

    def forward(self, feats):
        return [getattr(self, n)(f) for n, f in zip(HEAD_NAMES, feats)]


class YOLOX(nn.Module):
    def __init__(self, num_class: int, spec: YOLOXSpec = YOLOX_SIZES["s"],
                 num_anchor: int = 1, generator: torch.Generator | None = None,
                 dtype=torch.float32, remat: bool = False, s2d_stem: bool = False):
        super().__init__()
        self.num_class, self.num_anchor = num_class, num_anchor
        self.neck = CSPTrunk(spec.trunk, generator, dtype=dtype, remat=remat,
                             s2d_stem=s2d_stem)
        self.detect = _Detect(self.neck.out_channels, num_class, spec.head_width, num_anchor,
                              spec.tower_depth, generator)

    def forward(self, x: torch.Tensor):
        return self.detect(self.neck(x))


class DarknetBackbone(nn.Module):
    """Plain residual DarkNet: a 3x3 stem of width 32, then per stage a
    3x3/2 conv doubling the width and ``num_blocks[i]`` 1x1 -> 3x3
    bottlenecks. Returns the /8, /16, /32 maps."""

    def __init__(self, num_blocks=(1, 2, 8, 8, 4), generator: torch.Generator | None = None):
        super().__init__()
        g, ch = generator, 32
        self.stem = ConvBnAct(3, ch, 3, generator=g)
        self.num_blocks = tuple(num_blocks)
        for si, nb in enumerate(self.num_blocks):
            setattr(self, f"s{si}_down", ConvBnAct(ch, 2 * ch, 3, 2, generator=g))
            ch *= 2
            for bi in range(nb):
                setattr(self, f"s{si}_b{bi}", BasicBottleneck(ch, ch, True, 0.5, generator=g))
        self.out_channels = (ch // 4, ch // 2, ch)

    def forward(self, x: torch.Tensor):
        x = self.stem(x)
        feats = []
        for si, nb in enumerate(self.num_blocks):
            x = getattr(self, f"s{si}_down")(x)
            for bi in range(nb):
                x = getattr(self, f"s{si}_b{bi}")(x)
            feats.append(x)
        return feats[-3], feats[-2], feats[-1]


class YOLOXDarknet(nn.Module):
    """DarkNet backbone, SPP bridge, top-down neck, decoupled heads (two
    conv blocks per tower)."""

    def __init__(self, num_class: int, num_blocks=(1, 2, 8, 8, 4), head_width: int = 128,
                 num_anchor: int = 1, generator: torch.Generator | None = None,
                 dtype=torch.float32):
        super().__init__()
        g = generator
        self.num_class, self.num_anchor, self.dtype = num_class, num_anchor, dtype
        self.backbone = DarknetBackbone(num_blocks, generator=g)
        c3, c4, w = self.backbone.out_channels
        self.bridge1 = ConvBnAct(w, w // 2, 1, generator=g)
        self.bridge2 = ConvBnAct(w // 2, w, 3, generator=g)
        self.spp = SPP(w, w // 2, generator=g)
        self.bridge3 = ConvBnAct(w // 2, w, 3, generator=g)
        self.bridge4 = ConvBnAct(w, w // 2, 1, generator=g)
        self.lat5 = ConvBnAct(w // 2, w // 4, 1, generator=g)
        self.fuse4 = ConvBnAct(w // 4 + c4, w // 4, 1, generator=g)
        self.lat4 = ConvBnAct(w // 4, w // 8, 1, generator=g)
        self.fuse3 = ConvBnAct(w // 8 + c3, w // 8, 1, generator=g)
        self.detect = _Detect((w // 8, w // 4, w // 2), num_class, head_width, num_anchor, 2, g)

    def forward(self, x: torch.Tensor):
        c3, c4, c5 = self.backbone(x.to(self.dtype))
        y = self.bridge2(self.bridge1(c5))
        p5 = self.bridge4(self.bridge3(self.spp(y)))
        p4 = self.fuse4(torch.cat([upsample2x(self.lat5(p5)), c4], dim=1))
        p3 = self.fuse3(torch.cat([upsample2x(self.lat4(p4)), c3], dim=1))
        return self.detect([p3, p4, p5])
