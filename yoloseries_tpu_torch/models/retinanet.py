"""RetinaNet: ResNet-50 backbone, P3-P7 FPN, shared cls/reg towers, NCHW.

Counterpart of ``yoloseries_tpu/models/retinanet.py``:

* ResNet bottleneck backbone (7x7/2 stem, 3x3/2 max pool, ``resnet_layers``
  blocks per stage, default (3, 4, 6, 3)), BN eps 1e-3 and torch momentum
  0.03 everywhere (the reference's ``_init_weights`` sets every BN so);
  taps c3/c4/c5;
* a conv-only FPN (biased convs): lateral 1x1 + top-down add + 3x3 smooth,
  P6 a 3x3/2 conv on c5, P7 a 3x3/2 conv on relu(P6). The reference's
  in-place ReLU writes over P6, so the towers take relu(P6) as well: kept;
* two towers shared over the levels, 4 x (biased 3x3 conv + ReLU) and a
  3x3 output conv; every bias of the classification tower starts at the
  focal prior -log(99), the regression tower's at 0;
* 9 anchors a cell. ``with_objectness`` is the "experiment" variant: its
  regression carries a fifth, objectness channel.

Knobs as in the JAX package: ``dtype`` and ``remat`` (each bottleneck block
recomputed in the backward).

Names: torchvision's (``backbone.conv1``, ``backbone.bn1``,
``backbone.layer2.0.downsample.1``), ``fpn.p5_1``..``fpn.p7``,
``classification.conv1``..``conv4`` and ``.output``, so that
``convert_retinanet_state_dict`` of the JAX package reads a port
``state_dict``.

Input (B, 3, H, W) in [0, 1]. Returns ``RetinaNetOutput(regression
(B, N, 4 or 5), logits (B, N, nc), level_hw)`` over the N = sum_l H_l * W_l
* 9 anchors, level by level, each level's cells row-major with the anchor
fastest: the order of ``ops/anchors.py::pyramid_anchors``. The first two
are the JAX model's outputs; ``level_hw``, the (H_l, W_l) of P3..P7, lets
the loss and the decoders lay the anchors on the maps the model made, at
any input size (the JAX package's family lays them for its
``input_size``, and maps of any other size read anchors of the wrong
cells).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.layers import BatchNorm, Conv2d, kaiming_fan_out_, remat_context, upsample2x

__all__ = ["Bottleneck", "FPN", "ResNetBackbone", "RetinaNet", "RetinaNetOutput", "prior_bias"]


class RetinaNetOutput(NamedTuple):
    regression: torch.Tensor  # (B, N, 4 | 5)
    classification: torch.Tensor  # (B, N, nc) logits
    level_hw: tuple  # ((H, W) of P3, ..., of P7)


def prior_bias(prior_prob: float = 0.01) -> float:
    """The focal prior's logit: -log((1 - p) / p)."""
    return -math.log((1 - prior_prob) / prior_prob)


def conv(cin, cout, k, stride=1, bias=True, generator=None, std=None):
    """A ``Conv2d`` with padding k // 2: kaiming fan-out weights (or
    N(0, std)), zero bias."""
    c = Conv2d(cin, cout, k, stride, k // 2, bias=bias)
    if std is None:
        kaiming_fan_out_(c.weight, generator)
    else:
        with torch.no_grad():
            c.weight.normal_(0.0, std, generator=generator)
    if bias:
        nn.init.zeros_(c.bias)
    return c


def _relu(y, like):
    """ReLU, rounded once to the compute dtype of ``like``."""
    return F.relu(y).to(like.dtype)


class Bottleneck(nn.Module):
    """ResNet bottleneck 1x1-3x3-1x1, expansion 4, with ``norm(channels)``
    after each conv (BatchNorm here, GroupNorm in FCOS); ``downsample``
    (conv + norm) when the stride or the width changes."""

    def __init__(self, cin, planes, stride=1, norm=BatchNorm, generator=None):
        super().__init__()
        out = planes * 4
        self.conv1 = conv(cin, planes, 1, bias=False, generator=generator)
        self.bn1 = norm(planes)
        self.conv2 = conv(planes, planes, 3, stride, bias=False, generator=generator)
        self.bn2 = norm(planes)
        self.conv3 = conv(planes, out, 1, bias=False, generator=generator)
        self.bn3 = norm(out)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(
                Conv2d(cin, out, 1, stride, bias=False), norm(out))
            kaiming_fan_out_(self.downsample[0].weight, generator)

    def forward(self, x):
        y = _relu(self.bn1(self.conv1(x)), x)
        y = _relu(self.bn2(self.conv2(y)), x)
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return _relu(y + identity, x)


class ResNetBackbone(nn.Module):
    """Stem + four bottleneck stages; returns c3 (/8), c4 (/16), c5 (/32)."""

    def __init__(self, layers=(3, 4, 6, 3), inplane=64, norm=BatchNorm, remat=False,
                 generator=None):
        super().__init__()
        self.remat = remat
        self.conv1 = conv(3, inplane, 7, 2, bias=False, generator=generator)
        self.bn1 = norm(inplane)
        cin = inplane
        for si, n in enumerate(layers):
            planes = inplane * 2 ** si
            blocks = []
            for bi in range(n):
                blocks.append(Bottleneck(cin, planes, 1 if si == 0 or bi else 2, norm,
                                         generator))
                cin = planes * 4
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.out_channels = tuple(inplane * 2 ** si * 4 for si in (1, 2, 3))

    def forward(self, x):
        x = F.max_pool2d(_relu(self.bn1(self.conv1(x)), x), 3, 2, 1)
        feats = []
        for si in range(4):
            for block in getattr(self, f"layer{si + 1}"):
                if self.remat and self.training and torch.is_grad_enabled():
                    x = checkpoint(block, x, use_reentrant=False, context_fn=remat_context)
                else:
                    x = block(x)
            feats.append(x)
        return feats[1], feats[2], feats[3]


class FPN(nn.Module):
    """RetinaNet's P3-P7 pyramid (P6 from c5)."""

    def __init__(self, in_channels, feature_size=256, generator=None):
        super().__init__()
        c3, c4, c5 = in_channels
        fs, g = feature_size, generator
        self.p5_1, self.p5_2 = conv(c5, fs, 1, generator=g), conv(fs, fs, 3, generator=g)
        self.p4_1, self.p4_2 = conv(c4, fs, 1, generator=g), conv(fs, fs, 3, generator=g)
        self.p3_1, self.p3_2 = conv(c3, fs, 1, generator=g), conv(fs, fs, 3, generator=g)
        self.p6 = conv(c5, fs, 3, 2, generator=g)
        self.p7 = conv(fs, fs, 3, 2, generator=g)

    def forward(self, c3, c4, c5):
        p5_lat = self.p5_1(c5)
        p5 = self.p5_2(p5_lat)
        p4_lat = self.p4_1(c4) + upsample2x(p5_lat)
        p4 = self.p4_2(p4_lat)
        p3 = self.p3_2(self.p3_1(c3) + upsample2x(p4_lat))
        p6 = F.relu(self.p6(c5))  # the reference's in-place ReLU: the towers see relu(P6)
        return p3, p4, p5, p6, self.p7(p6)


class _Tower(nn.Module):
    def __init__(self, out_channels, inner=256, bias=0.0, generator=None):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}", conv(inner, inner, 3, generator=generator))
        self.output = conv(inner, out_channels, 3, generator=generator)
        with torch.no_grad():
            for m in self.children():
                m.bias.fill_(bias)

    def forward(self, x):
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        return self.output(x)


class RetinaNet(nn.Module):
    def __init__(self, num_class: int, num_anchor: int = 9, resnet_layers=(3, 4, 6, 3),
                 with_objectness: bool = False, generator: torch.Generator | None = None,
                 dtype=torch.float32, remat: bool = False):
        super().__init__()
        self.num_class, self.num_anchor, self.dtype = num_class, num_anchor, dtype
        self.reg_dim = 5 if with_objectness else 4
        self.backbone = ResNetBackbone(resnet_layers, remat=remat, generator=generator)
        self.fpn = FPN(self.backbone.out_channels, generator=generator)
        self.regression = _Tower(num_anchor * self.reg_dim, generator=generator)
        self.classification = _Tower(num_anchor * num_class, bias=prior_bias(),
                                     generator=generator)

    def forward(self, x: torch.Tensor):
        pyramid = self.fpn(*self.backbone(x.to(self.dtype)))
        regs, clss, level_hw = [], [], []
        for p in pyramid:
            b, _, h, w = p.shape
            level_hw.append((h, w))
            n = h * w * self.num_anchor
            regs.append(self.regression(p).permute(0, 2, 3, 1).reshape(b, n, self.reg_dim))
            clss.append(self.classification(p).permute(0, 2, 3, 1).reshape(b, n,
                                                                          self.num_class))
        return RetinaNetOutput(torch.cat(regs, dim=1), torch.cat(clss, dim=1), tuple(level_hw))
