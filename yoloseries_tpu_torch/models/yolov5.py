"""YOLOv5 family: one NCHW graph parameterized by a size spec.

Counterpart of ``yoloseries_tpu/models/yolov5.py``: 6x6/2 conv stem,
CSPDarknet backbone (4 x [3x3/2 conv -> C3]) with a FastSPP tail, PANet
neck (two top-down, two bottom-up stages) and a 1x1 detect conv per scale.

Submodules carry the reference's ``state_dict`` names (``focus``,
``backbone_stage1_conv``, ..., ``detect.detect_small``), so
``yoloseries_tpu.utils.torch_import.convert_yolov5_state_dict`` reads a
port ``state_dict`` directly.

Input (B, 3, H, W) float in [0, 1], H and W multiples of 32. Returns three
raw maps (B, A*(5+nc), H/s, W/s) for s = 8, 16, 32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..nn.layers import C3BottleneckCSP, ConvBnAct, DetectHead, FastSPP, upsample2x

__all__ = ["CSPTrunk", "YOLOv5", "YOLOV5_SIZES", "YOLOv5Spec"]


@dataclasses.dataclass(frozen=True)
class YOLOv5Spec:
    base_width: int  # stem channels; stages are x2, x4, x8, x16
    backbone_depths: tuple  # C3 block counts for the 4 backbone stages
    head_depth: int  # C3 block count for each of the 4 head stages
    depthwise: bool = False
    plain_bscp: bool = False  # BottleneckCSP instead of C3 (yolov5s_plain_bscp)


YOLOV5_SIZES: dict[str, YOLOv5Spec] = {
    "s": YOLOv5Spec(32, (1, 2, 3, 1), 1),
    "m": YOLOv5Spec(48, (2, 4, 6, 2), 2),
    "l": YOLOv5Spec(64, (3, 6, 9, 3), 3),
    "x": YOLOv5Spec(80, (4, 12, 12, 4), 4),
    "s_plain": YOLOv5Spec(32, (1, 2, 3, 1), 1, plain_bscp=True),
    "s_dw": YOLOv5Spec(32, (1, 3, 3, 1), 1, depthwise=True),
    "m_dw": YOLOv5Spec(48, (2, 6, 6, 2), 2, depthwise=True),
    "l_dw": YOLOv5Spec(64, (3, 9, 9, 3), 3, depthwise=True),
    "x_dw": YOLOv5Spec(80, (4, 12, 12, 4), 4, depthwise=True),
}


class CSPTrunk(nn.Module):
    """CSPDarknet backbone + PANet neck. Returns the three PAN maps at
    strides 8/16/32 with channels (4w, 8w, 16w)."""

    def __init__(self, spec: YOLOv5Spec = YOLOV5_SIZES["s"],
                 generator: torch.Generator | None = None):
        super().__init__()
        if spec.depthwise or spec.plain_bscp:
            raise NotImplementedError(
                "the depthwise and plain-BottleneckCSP YOLOv5 specs need blocks "
                "not ported yet (ROADMAP queue A, 'YOLOv5 model variants')"
            )
        w, d, hd, g = spec.base_width, spec.backbone_depths, spec.head_depth, generator

        def conv(cin, cout, k, s):
            return ConvBnAct(cin, cout, k, s, padding=0 if k == 1 else None,
                             generator=g)

        self.focus = ConvBnAct(3, w, 6, 2, padding=2, generator=g)
        self.backbone_stage1_conv = conv(w, 2 * w, 3, 2)
        self.backbone_stage1_bscp = C3BottleneckCSP(2 * w, 2 * w, True, d[0], g)
        self.backbone_stage2_conv = conv(2 * w, 4 * w, 3, 2)
        self.backbone_stage2_bscp = C3BottleneckCSP(4 * w, 4 * w, True, d[1], g)
        self.backbone_stage3_conv = conv(4 * w, 8 * w, 3, 2)
        self.backbone_stage3_bscp = C3BottleneckCSP(8 * w, 8 * w, True, d[2], g)
        self.backbone_stage4_conv = conv(8 * w, 16 * w, 3, 2)
        self.backbone_stage4_bscp = C3BottleneckCSP(16 * w, 16 * w, True, d[3], g)
        self.backbone_stage4_spp = FastSPP(16 * w, 16 * w, generator=g)
        self.head_stage1_conv = conv(16 * w, 8 * w, 1, 1)
        self.head_stage1_bscp = C3BottleneckCSP(16 * w, 8 * w, False, hd, g)
        self.head_stage2_conv = conv(8 * w, 4 * w, 1, 1)
        self.head_stage2_bscp = C3BottleneckCSP(8 * w, 4 * w, False, hd, g)
        self.head_stage3_conv = conv(4 * w, 4 * w, 3, 2)
        self.head_stage3_bscp = C3BottleneckCSP(8 * w, 8 * w, False, hd, g)
        self.head_stage4_conv = conv(8 * w, 8 * w, 3, 2)
        self.head_stage4_bscp = C3BottleneckCSP(16 * w, 16 * w, False, hd, g)
        self.out_channels = (4 * w, 8 * w, 16 * w)

    def forward(self, x: torch.Tensor):
        x = self.focus(x)
        x = self.backbone_stage1_bscp(self.backbone_stage1_conv(x))  # /4
        p3 = self.backbone_stage2_bscp(self.backbone_stage2_conv(x))  # /8
        p4 = self.backbone_stage3_bscp(self.backbone_stage3_conv(p3))  # /16
        x = self.backbone_stage4_bscp(self.backbone_stage4_conv(p4))  # /32
        p5 = self.backbone_stage4_spp(x)

        h1 = self.head_stage1_conv(p5)
        x = self.head_stage1_bscp(torch.cat([upsample2x(h1), p4], dim=1))  # /16
        h2 = self.head_stage2_conv(x)
        out_small = self.head_stage2_bscp(torch.cat([upsample2x(h2), p3], dim=1))

        x = self.head_stage3_conv(out_small)  # /16
        out_mid = self.head_stage3_bscp(torch.cat([x, h2], dim=1))
        x = self.head_stage4_conv(out_mid)  # /32
        out_large = self.head_stage4_bscp(torch.cat([x, h1], dim=1))
        return [out_small, out_mid, out_large]


class YOLOv5(CSPTrunk):
    """Trunk + detect head. The reference keeps the trunk's modules at the
    top level of its ``state_dict``, so this class extends the trunk rather
    than nesting it under a ``trunk`` submodule."""

    def __init__(self, num_class: int, spec: YOLOv5Spec = YOLOV5_SIZES["s"],
                 num_anchor: int = 3, generator: torch.Generator | None = None):
        super().__init__(spec, generator)
        self.num_class = num_class
        self.num_anchor = num_anchor
        self.detect = DetectHead(self.out_channels, num_class, num_anchor,
                                 generator=generator)

    def forward(self, x: torch.Tensor):
        return self.detect(super().forward(x))
