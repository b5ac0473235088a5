"""YOLOv8: C2f backbone and PAN over four scales, split DFL heads.

Counterpart of ``yoloseries_tpu/models/yolov8.py``: two 3x3/2 stem convs,
four backbone stages of [C2f, 3x3/2 conv] with a FastSPP tail, C2f depths
``int((3, 6, 6, 3) * scale)`` (at least 1; widths are not scaled), a PAN
over the /4, /8, /16, /32 maps, and per scale a box branch (two 3x3
ConvBnAct at c/4, a 1x1 conv to 4 * reg DFL logits, bias 1.0) beside a cls
branch (two 3x3 ConvBnAct at 128, a 1x1 conv to nc, bias
log(5 / nc / (640 / s)^2)).

Knobs as in the JAX package: ``dtype`` (the compute dtype), ``remat`` (each
C2f recomputed in the backward through ``torch.utils.checkpoint``).

Names: the reference's ``state_dict`` keys (``backbone_stem1``, ...,
``head_stage1_c2f2``; C2f's ``conv1``/``conv2``/``block.N``; heads
``detect.detect_{xsmall,small,mid,large}_{bbox,cls}.{0,1,2}``), so
``convert_yolov8_state_dict`` of the JAX package reads a port
``state_dict``.

Input (B, 3, H, W) in [0, 1], H and W multiples of 32. Returns four raw
maps (B, 4*reg + nc, H/s, W/s) at s = 4, 8, 16, 32, channels [dfl, cls].
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.layers import C2f, Conv2d, ConvBnAct, FastSPP, kaiming_fan_out_, remat_context, upsample2x

__all__ = ["YOLOv8", "V8_STRIDES"]

V8_STRIDES = (4, 8, 16, 32)
_SCALES = ("xsmall", "small", "mid", "large")


def _branch(cin, mid, cout, bias, generator):
    conv = Conv2d(mid, cout, 1)
    kaiming_fan_out_(conv.weight, generator)
    with torch.no_grad():
        conv.bias.fill_(bias)
    return nn.Sequential(ConvBnAct(cin, mid, 3, generator=generator),
                         ConvBnAct(mid, mid, 3, generator=generator), conv)


class _Detect(nn.Module):
    def __init__(self, in_channels, num_class, reg, generator):
        super().__init__()
        for scale, ch, s in zip(_SCALES, in_channels, V8_STRIDES):
            setattr(self, f"detect_{scale}_bbox", _branch(ch, ch // 4, 4 * reg, 1.0, generator))
            setattr(self, f"detect_{scale}_cls",
                    _branch(ch, 128, num_class, math.log(5 / num_class / (640 / s) ** 2),
                            generator))

    def forward(self, feats):
        return [torch.cat([getattr(self, f"detect_{scale}_bbox")(f),
                           getattr(self, f"detect_{scale}_cls")(f)], dim=1)
                for scale, f in zip(_SCALES, feats)]


class YOLOv8(nn.Module):
    def __init__(self, num_class: int, scale: float = 0.5, reg: int = 16,
                 generator: torch.Generator | None = None, dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        g = generator
        self.num_class, self.reg, self.dtype, self.remat = num_class, reg, dtype, remat
        d3, d6 = max(int(3 * scale), 1), max(int(6 * scale), 1)

        def cba(cin, cout):
            return ConvBnAct(cin, cout, 3, 2, generator=g)

        def c2f(cin, cout, shortcut, d=d3):
            return C2f(cin, cout, shortcut, d, generator=g)

        self.backbone_stem1 = cba(3, 64)  # /2
        self.backbone_stem2 = cba(64, 128)  # /4
        self.backbone_stage1_c2f = c2f(128, 128, True)
        self.backbone_stage1_conv = cba(128, 256)  # /8
        self.backbone_stage2_c2f = c2f(256, 256, True, d6)
        self.backbone_stage2_conv = cba(256, 512)  # /16
        self.backbone_stage3_c2f = c2f(512, 512, True, d6)
        self.backbone_stage3_conv = cba(512, 1024)  # /32
        self.backbone_stage4_c2f = c2f(1024, 1024, True)
        self.backbone_stage4_spp = FastSPP(1024, 1024, generator=g)
        self.head_stage1_c2f1 = c2f(1024 + 512, 512, False)  # /16
        self.head_stage2_c2f1 = c2f(512 + 256, 256, False)  # /8
        self.head_stage3_c2f1 = c2f(256 + 128, 128, False)  # /4
        self.head_stage3_conv = cba(128, 128)
        self.head_stage3_c2f2 = c2f(128 + 256, 256, False)  # /8
        self.head_stage2_conv = cba(256, 256)
        self.head_stage2_c2f2 = c2f(256 + 512, 512, False)  # /16
        self.head_stage1_conv = cba(512, 512)
        self.head_stage1_c2f2 = c2f(512 + 1024, 1024, False)  # /32
        self.detect = _Detect((128, 256, 512, 1024), num_class, reg, g)

    def _c2f(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False, context_fn=remat_context)
        return block(x)

    def forward(self, x: torch.Tensor):
        c2f = self._c2f
        x = self.backbone_stem2(self.backbone_stem1(x.to(self.dtype)))
        x2 = c2f(self.backbone_stage1_c2f, x)  # /4
        x4 = c2f(self.backbone_stage2_c2f, self.backbone_stage1_conv(x2))  # /8
        x6 = c2f(self.backbone_stage3_c2f, self.backbone_stage2_conv(x4))  # /16
        x8 = c2f(self.backbone_stage4_c2f, self.backbone_stage3_conv(x6))  # /32
        x9 = self.backbone_stage4_spp(x8)

        x12 = c2f(self.head_stage1_c2f1, torch.cat([upsample2x(x9), x6], dim=1))  # /16
        x15 = c2f(self.head_stage2_c2f1, torch.cat([upsample2x(x12), x4], dim=1))  # /8
        x18 = c2f(self.head_stage3_c2f1, torch.cat([upsample2x(x15), x2], dim=1))  # /4

        x21 = c2f(self.head_stage3_c2f2, torch.cat([self.head_stage3_conv(x18), x15], dim=1))
        x24 = c2f(self.head_stage2_c2f2, torch.cat([self.head_stage2_conv(x21), x12], dim=1))
        x27 = c2f(self.head_stage1_c2f2, torch.cat([self.head_stage1_conv(x24), x9], dim=1))
        return self.detect([x18, x21, x24, x27])
