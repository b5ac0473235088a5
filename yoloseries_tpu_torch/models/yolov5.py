"""YOLOv5 family: one NCHW graph parameterized by a size spec.

Counterpart of ``yoloseries_tpu/models/yolov5.py``: 6x6/2 conv stem,
CSPDarknet backbone (4 x [3x3/2 conv -> CSP block]) with a FastSPP tail,
PANet neck (two top-down, two bottom-up stages) and a 1x1 detect conv per
scale. The depthwise specs take a ``Focus`` 3x3 stem, depthwise 3x3 convs,
and the 5/9/13 ``SPP`` before a non-shortcut final backbone block;
``s_plain`` takes ``BottleneckCSP`` in place of C3.

Knobs, as in the JAX package: ``dtype`` (the compute dtype: the input is
cast once, parameters and BN statistics stay f32), ``remat`` (each CSP
block recomputed in the backward through ``torch.utils.checkpoint``),
``s2d_stem`` (the 6x6/2 stem as a 3x3/1 conv over ``space_to_depth2`` of
the image; ``nn/deploy.py::fold_stem_to_s2d`` maps its weights).

Submodules carry the reference's ``state_dict`` names (``focus``,
``backbone_stage1_conv``, ..., ``detect.detect_small``), so
``yoloseries_tpu.utils.torch_import.convert_yolov5_state_dict`` reads a
port ``state_dict`` directly (every spec but ``s_plain``).

Input (B, 3, H, W) float in [0, 1], H and W multiples of 32. Returns three
raw maps (B, A*(5+nc), H/s, W/s) for s = 8, 16, 32, in the compute dtype.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.layers import (
    SPP,
    BottleneckCSP,
    C3BottleneckCSP,
    ConvBnAct,
    DetectHead,
    DWConvBnAct,
    FastSPP,
    Focus,
    remat_context,
    upsample2x,
)

__all__ = ["CSPTrunk", "YOLOv5", "YOLOV5_SIZES", "YOLOv5Spec", "space_to_depth2"]


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2); channel (2*dy + dx) * C + c holds
    pixel (2y + dy, 2x + dx) of channel c, the JAX package's (dy, dx, c)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


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
                 generator: torch.Generator | None = None, dtype=torch.float32,
                 remat: bool = False, s2d_stem: bool = False):
        super().__init__()
        w, d, hd, g = spec.base_width, spec.backbone_depths, spec.head_depth, generator
        dw = spec.depthwise
        self.dtype, self.remat = dtype, remat
        self.s2d_stem = s2d_stem and not dw  # the depthwise stem is Focus

        def conv(cin, cout, k, s):
            if dw and k > 1:
                return DWConvBnAct(cin, cout, k, s, generator=g)
            return ConvBnAct(cin, cout, k, s, padding=0 if k == 1 else None, generator=g)

        csp = BottleneckCSP if spec.plain_bscp else C3BottleneckCSP
        if dw:
            self.focus = Focus(3, w, 3, 1, generator=g)
        elif self.s2d_stem:
            self.focus = ConvBnAct(12, w, 3, 1, padding=1, generator=g)
        else:
            self.focus = ConvBnAct(3, w, 6, 2, padding=2, generator=g)
        self.backbone_stage1_conv = conv(w, 2 * w, 3, 2)
        self.backbone_stage1_bscp = csp(2 * w, 2 * w, True, d[0], g)
        self.backbone_stage2_conv = conv(2 * w, 4 * w, 3, 2)
        self.backbone_stage2_bscp = csp(4 * w, 4 * w, True, d[1], g)
        self.backbone_stage3_conv = conv(4 * w, 8 * w, 3, 2)
        self.backbone_stage3_bscp = csp(8 * w, 8 * w, True, d[2], g)
        self.backbone_stage4_conv = conv(8 * w, 16 * w, 3, 2)
        if dw:  # SPP before a non-shortcut final block
            self.backbone_stage4_spp = SPP(16 * w, 16 * w, generator=g)
            self.backbone_stage4_bscp = csp(16 * w, 16 * w, False, d[3], g)
        else:
            self.backbone_stage4_bscp = csp(16 * w, 16 * w, True, d[3], g)
            self.backbone_stage4_spp = FastSPP(16 * w, 16 * w, generator=g)
        self.head_stage1_conv = conv(16 * w, 8 * w, 1, 1)
        self.head_stage1_bscp = csp(16 * w, 8 * w, False, hd, g)
        self.head_stage2_conv = conv(8 * w, 4 * w, 1, 1)
        self.head_stage2_bscp = csp(8 * w, 4 * w, False, hd, g)
        self.head_stage3_conv = conv(4 * w, 4 * w, 3, 2)
        self.head_stage3_bscp = csp(8 * w, 8 * w, False, hd, g)
        self.head_stage4_conv = conv(8 * w, 8 * w, 3, 2)
        self.head_stage4_bscp = csp(16 * w, 16 * w, False, hd, g)
        self.out_channels = (4 * w, 8 * w, 16 * w)
        self._spp_first = dw

    def _csp(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False, context_fn=remat_context)
        return block(x)

    def forward(self, x: torch.Tensor):
        x = x.to(self.dtype)
        if self.s2d_stem:
            x = space_to_depth2(x)
        x = self.focus(x)
        x = self._csp(self.backbone_stage1_bscp, self.backbone_stage1_conv(x))  # /4
        p3 = self._csp(self.backbone_stage2_bscp, self.backbone_stage2_conv(x))  # /8
        p4 = self._csp(self.backbone_stage3_bscp, self.backbone_stage3_conv(p3))  # /16
        x = self.backbone_stage4_conv(p4)  # /32
        if self._spp_first:
            p5 = self._csp(self.backbone_stage4_bscp, self.backbone_stage4_spp(x))
        else:
            p5 = self.backbone_stage4_spp(self._csp(self.backbone_stage4_bscp, x))

        h1 = self.head_stage1_conv(p5)
        x = self._csp(self.head_stage1_bscp, torch.cat([upsample2x(h1), p4], dim=1))  # /16
        h2 = self.head_stage2_conv(x)
        out_small = self._csp(self.head_stage2_bscp, torch.cat([upsample2x(h2), p3], dim=1))

        x = self.head_stage3_conv(out_small)  # /16
        out_mid = self._csp(self.head_stage3_bscp, torch.cat([x, h2], dim=1))
        x = self.head_stage4_conv(out_mid)  # /32
        out_large = self._csp(self.head_stage4_bscp, torch.cat([x, h1], dim=1))
        return [out_small, out_mid, out_large]


class YOLOv5(CSPTrunk):
    """Trunk + detect head. The reference keeps the trunk's modules at the
    top level of its ``state_dict``, so this class extends the trunk rather
    than nesting it under a ``trunk`` submodule."""

    def __init__(self, num_class: int, spec: YOLOv5Spec = YOLOV5_SIZES["s"],
                 num_anchor: int = 3, generator: torch.Generator | None = None,
                 dtype=torch.float32, remat: bool = False, s2d_stem: bool = False):
        super().__init__(spec, generator, dtype=dtype, remat=remat, s2d_stem=s2d_stem)
        self.num_class = num_class
        self.num_anchor = num_anchor
        self.detect = DetectHead(self.out_channels, num_class, num_anchor,
                                 generator=generator)

    def forward(self, x: torch.Tensor):
        return self.detect(super().forward(x))
