"""FCOS: GroupNorm ResNet-50, P3-P7 FPN and a shared cls/ctr/reg head, and
the variant on YOLOv5s's CSP trunk, NCHW.

Counterpart of ``yoloseries_tpu/models/fcos.py``:

* backbone: the ResNet bottlenecks of ``models/retinanet.py`` with
  GroupNorm(32, eps 1e-5) in place of every BN, so the model holds no BN
  state at all;
* FPN: P5 from c5, P4 and P3 from the smoothed level above, P6 a 3x3/2
  conv on P5 (RetinaNet's comes from c5), P7 one on relu(P6); its convs
  drawn from N(0, 0.001);
* head, shared over the levels: 4 x (3x3 conv without bias + GroupNorm +
  ReLU) for the cls and for the reg tower; cls (nc, focal prior bias),
  centerness (1) off the reg tower, reg (4) times the level's ``Scale``,
  then ReLU;
* ``FCOSCSPNet``: the YOLOv5s ``CSPTrunk`` and a biased 1x1 conv to 256
  per level (``lat0..2``) into the same head at three levels.

Knobs as in the JAX package: ``dtype`` and ``remat`` (each bottleneck block,
or each CSP block of the trunk, recomputed in the backward).

Names: ``FCOS`` takes the reference's (``backbone.layer1.0.bn1``, the
GroupNorms named ``bn`` as there, ``head.cls_layers.0.1``,
``head.cls_out_layer``, ``head.scales.0.scale``), so that
``convert_fcos_state_dict`` of the JAX package reads a port
``state_dict``. ``FCOSCSPNet`` has no reference converter: its trunk takes
YOLOv5's names under ``trunk.``.

Input (B, 3, H, W) in [0, 1]. Returns (cls maps, reg maps, ctr maps), one
(B, nc | 4 | 1, H_l, W_l) map each per level; reg is post-ReLU ltrb in
stride units.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import GroupNorm, Scale, upsample2x
from .retinanet import ResNetBackbone, conv, prior_bias
from .yolov5 import YOLOV5_SIZES, CSPTrunk

__all__ = ["FCOS", "FCOSCSPNet", "FCOSFPN", "FCOSHead"]


class FCOSFPN(nn.Module):
    def __init__(self, in_channels, feature_size=256, generator=None):
        super().__init__()
        c3, c4, c5 = in_channels
        fs, g = feature_size, generator

        def c(cin, k, s=1):
            return conv(cin, fs, k, s, generator=g, std=0.001)

        self.p5_1, self.p5_2 = c(c5, 1), c(fs, 3)
        self.p4_1, self.p4_2 = c(c4, 1), c(fs, 3)
        self.p3_1, self.p3_2 = c(c3, 1), c(fs, 3)
        self.p6, self.p7 = c(fs, 3, 2), c(fs, 3, 2)

    def forward(self, c3, c4, c5):
        p5 = self.p5_2(self.p5_1(c5))
        p4 = self.p4_2(self.p4_1(c4) + upsample2x(p5))
        p3 = self.p3_2(self.p3_1(c3) + upsample2x(p4))
        p6 = self.p6(p5)
        return p3, p4, p5, p6, self.p7(F.relu(p6))


class FCOSHead(nn.Module):
    def __init__(self, num_class, in_channels=256, num_levels=5, enable_scale=True,
                 generator=None):
        super().__init__()
        g, ch = generator, in_channels

        def tower():
            return nn.ModuleList(nn.Sequential(conv(ch, ch, 3, bias=False, generator=g),
                                               GroupNorm(ch)) for _ in range(4))

        self.cls_layers, self.reg_layers = tower(), tower()
        self.cls_out_layer = conv(ch, num_class, 3, generator=g)
        self.reg_out_layer = conv(ch, 4, 3, generator=g)
        self.ctr_out_layer = conv(ch, 1, 3, generator=g)
        with torch.no_grad():
            self.cls_out_layer.bias.fill_(prior_bias())
        self.scales = (nn.ModuleList(Scale() for _ in range(num_levels)) if enable_scale
                       else None)

    def forward(self, feats):
        cls_fms, reg_fms, ctr_fms = [], [], []
        for li, f in enumerate(feats):
            c, r = f, f
            for layer in self.cls_layers:
                c = F.relu(layer(c))
            for layer in self.reg_layers:
                r = F.relu(layer(r))
            cls_fms.append(self.cls_out_layer(c))
            ctr_fms.append(self.ctr_out_layer(r))
            reg = self.reg_out_layer(r)
            if self.scales is not None:
                reg = self.scales[li](reg)
            reg_fms.append(F.relu(reg))
        return cls_fms, reg_fms, ctr_fms


class FCOS(nn.Module):
    def __init__(self, num_class: int, resnet_layers=(3, 4, 6, 3), enable_scale: bool = True,
                 generator: torch.Generator | None = None, dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        self.num_class, self.dtype = num_class, dtype
        self.backbone = ResNetBackbone(resnet_layers, norm=GroupNorm, remat=remat,
                                       generator=generator)
        self.fpn = FCOSFPN(self.backbone.out_channels, generator=generator)
        self.head = FCOSHead(num_class, num_levels=5, enable_scale=enable_scale,
                             generator=generator)

    def forward(self, x: torch.Tensor):
        return self.head(self.fpn(*self.backbone(x.to(self.dtype))))


class FCOSCSPNet(nn.Module):
    def __init__(self, num_class: int, enable_scale: bool = True,
                 generator: torch.Generator | None = None, dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        self.num_class = num_class
        self.trunk = CSPTrunk(YOLOV5_SIZES["s"], generator, dtype=dtype, remat=remat)
        for i, ch in enumerate(self.trunk.out_channels):
            setattr(self, f"lat{i}", conv(ch, 256, 1, generator=generator))
        self.head = FCOSHead(num_class, num_levels=3, enable_scale=enable_scale,
                             generator=generator)

    def forward(self, x: torch.Tensor):
        feats = self.trunk(x)
        return self.head([getattr(self, f"lat{i}")(f) for i, f in enumerate(feats)])
