"""YOLOX (Megvii-BaseDetection/YOLOX ``exps/default/yolox_s.py``): the CSP
trunk of ``models.csp_trunk`` under ``neck.``, then a decoupled head per
scale (a stem, a class branch, a box branch with its objectness); its loss
is ``yolox_loss.py``, written from Megvii's.

Output convs: obj and cls std 1.5, box std 0.5 with log 4 on w and h, so
boxes sit near their cell and about four strides wide, as YOLOv5's anchors
make its boxes.
"""

from __future__ import annotations

import math

import torch

from .. import detect, yolox_loss
from ..models import csp_trunk

STRIDES = (8, 16, 32)
HEADS = ("pred_small", "pred_middle", "pred_large")


def forward(net, x, cfg):
    """Raw maps (B, 5+nc, H/s, W/s) in the channel order [reg(4), obj, cls]."""
    feats = csp_trunk(net, x, cfg, pre="neck.")
    hw = round(cfg["head_width"] * cfg["width_multiple"])
    out = []
    for name, f in zip(HEADS, feats):
        p = f"detect.{name}"
        stem = net.cba(f"{p}.stem", f, hw, 3)
        cls = net.conv(f"{p}.cls.1", net.cba(f"{p}.cls.0", stem, hw, 3), cfg["nc"], 1, bias=True)
        reg_feat = net.cba(f"{p}.conv.0", stem, hw, 3)
        reg = net.conv(f"{p}.reg", reg_feat, 4, 1, bias=True)
        obj = net.conv(f"{p}.cof", reg_feat, 1, 1, bias=True)
        out.append(torch.cat([reg, obj, cls], 1))
    return out


def output_convs(cfg):
    box = (0.0, 0.0, math.log(4.0), math.log(4.0))
    out = []
    for i, n in enumerate(HEADS):
        p = f"detect.{n}"
        out += [(f"{p}.reg.weight", f"{p}.reg.bias", slice(0, 4), i, 0.5, box),
                (f"{p}.cof.weight", f"{p}.cof.bias", slice(4, 5), i, 1.5, 0.0),
                (f"{p}.cls.1.weight", f"{p}.cls.1.bias", slice(5, None), i, 1.5, 0.0)]
    return out


def decode(maps, cfg):
    """Centres ``(offset + cell) stride``, sizes ``exp(log size) stride``;
    the flat index of a candidate is (y * W + x)."""
    parts = []
    for m, s in zip(maps, STRIDES):
        r, _, grid = detect.stage_rows(m, 1)
        xy = (r[..., :2] + grid) * s
        wh = torch.exp(r[..., 2:4].clamp(-20.0, 20.0)) * s
        parts.append(detect.candidates(xy, wh, torch.sigmoid(r[..., 4]), r[..., 5:]))
    return detect.concat(parts)


def loss(cfg, hyp, size, device):
    def fn(maps, ann, balances):
        return yolox_loss.yolox_loss(maps, ann, balances, hyp, cfg["nc"], size)

    return fn, yolox_loss.initial_balances(device)
