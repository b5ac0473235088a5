"""YOLOv5 (ultralytics/yolov5 ``models/yolov5s.yaml``): the CSP trunk of
``models.csp_trunk``, then one 1x1 detect conv per scale over three
anchors a cell; its loss is ``yolov5_loss.py``, written from ultralytics'.

Output convs: std 1.5 and bias 0 on every channel.
"""

from __future__ import annotations

import torch

from .. import detect, yolov5_loss
from ..models import csp_trunk

STRIDES = (8, 16, 32)
HEADS = ("detect_small", "detect_mid", "detect_large")


def forward(net, x, cfg):
    """Raw maps (B, A*(5+nc), H/s, W/s), s = 8, 16, 32."""
    no = len(cfg["anchors"][0]) * (5 + cfg["nc"])
    feats = csp_trunk(net, x, cfg)
    return [net.conv(f"detect.{name}", f, no, 1, bias=True) for name, f in zip(HEADS, feats)]


def output_convs(cfg):
    return [(f"detect.{n}.weight", f"detect.{n}.bias", slice(None), i, 1.5, 0.0)
            for i, n in enumerate(HEADS)]


def decode(maps, cfg):
    """Centres ``(2 sigmoid - 0.5 + cell) stride``, sizes ``(2 sigmoid)^2
    anchor``; the flat index of a candidate is ((y * W + x) * A + a)."""
    anchors = cfg["anchors"]
    na = len(anchors[0])
    parts = []
    for si, (m, s) in enumerate(zip(maps, STRIDES)):
        r, a, grid = detect.stage_rows(m, na)
        anc = torch.tensor(anchors[si], dtype=torch.float32, device=r.device)[a]
        sig = torch.sigmoid(r[..., :4])
        xy = (sig[..., :2] * 2.0 - 0.5 + grid) * s
        wh = (sig[..., 2:4] * 2.0) ** 2 * anc
        parts.append(detect.candidates(xy, wh, torch.sigmoid(r[..., 4]), r[..., 5:]))
    return detect.concat(parts)


def loss(cfg, hyp, size, device):
    def fn(maps, ann, balances):
        return yolov5_loss.yolov5_loss(maps, ann, balances, cfg["anchors"], hyp, cfg["nc"], size)

    return fn, yolov5_loss.initial_balances(device)
