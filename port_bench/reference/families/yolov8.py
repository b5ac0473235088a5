"""YOLOv8 as YOLOSeries builds it (yl-jiang/YOLOSeries
``models/normal/yolov8.py:86-182`` at ``scale=0.5``, as ``train_yolov8.py``
calls it): not Ultralytics' YOLOv8. Widths are not scaled (64 to 1024
channels); C2f depths are ``int((3, 6, 6, 3) x scale)``, at least 1.

* Trunk: two 3x3/2 stem convs (64, 128), four stages of [C2f, 3x3/2 conv]
  (C2f with shortcuts; 128, 256, 512, 1024 channels), FastSPP (three
  chained 5x5 stride-1 max pools over half the channels, ``models._sppf``).
* PAN over four strides: top-down C2f at /16 (512), /8 (256), /4 (128)
  over the upsampled map and the backbone's, then bottom-up 3x3/2 convs
  and C2f at /8 (256), /16 (512), /32 (1024); no shortcuts in the neck.
* C2f: a 1x1 conv to 2 x (c / 2) split in halves, a chain of bottlenecks of
  two 3x3 convs at c / 2 on the last part (with its input added where the
  block has shortcuts), every part concatenated, a 1x1 conv to c.
* Head per stride, split: a box branch (two 3x3 conv + BN + SiLU at c / 4,
  a 1x1 conv to 4 x ``reg`` DFL logits, sides [t, b, l, r] each over
  ``reg`` bins) beside a class branch (two at 128, a 1x1 conv to nc); the
  raw map is [box, cls] on the channels. No objectness.

The loss is ``yolov8_loss.py``.

Output convs: the class conv std 1.5 with bias -4.6 (scores about 0.01,
the prior a trained head keeps on the background; the largest of 80 at a
cell about 0.1-0.3); the box conv std 0.5 with bias -0.7 j on bin j of each
side, so that each side's expectation is about 2 cells and boxes about four
strides wide, as YOLOv5's anchors make its boxes.

Decode: the cell centre (x + 0.5, y + 0.5) in grid units, each side the
expectation of the softmax over its bins of the values 1..``reg`` (bins
1-indexed, as YOLOSeries writes it), the box [cx - l, cy - t, cx + r, cy +
b] times the stride; the flat index of a candidate is (y * W + x), stages
in stride order.
"""

from __future__ import annotations

import torch

from .. import detect, yolov8_loss
from ..models import _sppf, _up
from ..yolov8_loss import boxes_in_cells, cells, rows, side_expectation

STRIDES = (4, 8, 16, 32)
SCALES = ("xsmall", "small", "mid", "large")
WIDTHS = (64, 128, 256, 512, 1024)  # the stem's, then each stage's: not scaled
DEPTHS = (3, 6, 6, 3)  # C2f blocks of the four backbone stages, times the scale
CLS_WIDTH = 128
CLS_BIAS = -4.6
BOX_BIN_BIAS = -0.7


def _depths(cfg):
    return [max(int(d * cfg["scale"]), 1) for d in DEPTHS]


def _c2f(net, p, x, cout, n, shortcut):
    mid = cout // 2
    y = net.cba(f"{p}.conv1", x, 2 * mid, 1)
    parts = [y[:, :mid], y[:, mid:]]
    for i in range(n):
        z = net.cba(f"{p}.block.{i}.conv1", parts[-1], mid, 3)
        z = net.cba(f"{p}.block.{i}.conv2", z, mid, 3)
        parts.append(z + parts[-1] if shortcut else z)
    return net.cba(f"{p}.conv2", torch.cat(parts, 1), cout, 1)


def _down(net, p, x, cout):
    return net.cba(p, x, cout, 3, 2)


def _branch(net, p, x, mid, cout):
    x = net.cba(f"{p}.1", net.cba(f"{p}.0", x, mid, 3), mid, 3)
    return net.conv(f"{p}.2", x, cout, 1, bias=True)


def forward(net, x, cfg):
    """Raw maps (B, 4 * reg + nc, H/s, W/s), s = 4, 8, 16, 32."""
    w0, w1, w2, w3, w4 = WIDTHS
    d1, d2, d3, d4 = _depths(cfg)
    dn = d1  # the neck's C2f: int(3 x scale)
    x = _down(net, "backbone_stem2", _down(net, "backbone_stem1", x, w0), w1)
    x2 = _c2f(net, "backbone_stage1_c2f", x, w1, d1, True)  # /4
    x4 = _c2f(net, "backbone_stage2_c2f", _down(net, "backbone_stage1_conv", x2, w2), w2, d2,
              True)  # /8
    x6 = _c2f(net, "backbone_stage3_c2f", _down(net, "backbone_stage2_conv", x4, w3), w3, d3,
              True)  # /16
    x8 = _c2f(net, "backbone_stage4_c2f", _down(net, "backbone_stage3_conv", x6, w4), w4, d4,
              True)  # /32
    x9 = _sppf(net, "backbone_stage4_spp", x8, w4)
    x12 = _c2f(net, "head_stage1_c2f1", torch.cat([_up(x9), x6], 1), w3, dn, False)
    x15 = _c2f(net, "head_stage2_c2f1", torch.cat([_up(x12), x4], 1), w2, dn, False)
    x18 = _c2f(net, "head_stage3_c2f1", torch.cat([_up(x15), x2], 1), w1, dn, False)
    x21 = _c2f(net, "head_stage3_c2f2",
               torch.cat([_down(net, "head_stage3_conv", x18, w1), x15], 1), w2, dn, False)
    x24 = _c2f(net, "head_stage2_c2f2",
               torch.cat([_down(net, "head_stage2_conv", x21, w2), x12], 1), w3, dn, False)
    x27 = _c2f(net, "head_stage1_c2f2",
               torch.cat([_down(net, "head_stage1_conv", x24, w3), x9], 1), w4, dn, False)
    reg, out = cfg["reg"], []
    for scale, f in zip(SCALES, (x18, x21, x24, x27)):
        p = f"detect.detect_{scale}"
        box = _branch(net, f"{p}_bbox", f, f.shape[1] // 4, 4 * reg)
        cls = _branch(net, f"{p}_cls", f, CLS_WIDTH, cfg["nc"])
        out.append(torch.cat([box, cls], 1))
    return out


def output_convs(cfg):
    reg = cfg["reg"]
    box_bias = tuple(BOX_BIN_BIAS * j for _ in range(4) for j in range(reg))
    out = []
    for i, scale in enumerate(SCALES):
        p = f"detect.detect_{scale}"
        out += [(f"{p}_bbox.2.weight", f"{p}_bbox.2.bias", slice(0, 4 * reg), i, 0.5, box_bias),
                (f"{p}_cls.2.weight", f"{p}_cls.2.bias", slice(4 * reg, None), i, 1.5, CLS_BIAS)]
    return out


def decode(maps, cfg):
    reg = cfg["reg"]
    r = rows(maps)
    centres, strides = cells(maps, cfg["strides"])
    xyxy = boxes_in_cells(side_expectation(r[..., :4 * reg], reg), centres) * strides
    xy, wh = (xyxy[..., :2] + xyxy[..., 2:]) / 2, xyxy[..., 2:] - xyxy[..., :2]
    obj = torch.ones_like(xy[..., 0])
    return detect.candidates(xy, wh, obj, r[..., 4 * reg:])


def loss(cfg, hyp, size, device):
    def fn(maps, ann, balances):
        return yolov8_loss.yolov8_loss(maps, ann, hyp, cfg), balances

    return fn, torch.ones(1, device=device)
