"""RetinaNet decode: the anchor delta transform; counterpart of
``yoloseries_tpu/evaluation/retinanet.py``.

Deltas (dx, dy, dw, dh) times the scale factors move and scale each
anchor's xywh; the class logits go through the sigmoid. Rows follow the
shared postprocess contract [cx, cy, w, h, obj, cls...], obj 1 for the base
model and sigmoid of the fifth regression channel for the experiment
variant. With ``clip_size`` (h, w) the boxes are rounded and clamped to the
image, as the reference's ``bbox_clip`` does.

``anchors`` is an (A, 4) xyxy array or tensor; ``anchors_for`` lays them on
the maps of a ``RetinaNetOutput`` (its ``level_hw``), once per map sizes
and device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.anchors import level_anchors
from ..ops.boxes import xyxy2xywh

__all__ = ["anchors_for", "decode_retinanet", "decode_topk_retinanet"]


@functools.lru_cache(maxsize=16)
def anchors_for(level_hw: tuple, device) -> torch.Tensor:
    """The (A, 4) xyxy anchors of maps of ``level_hw``, on ``device``."""
    return torch.from_numpy(level_anchors(level_hw)).to(device)


def _round_clip_xyxy(boxes, clip_size):
    """Round, then clamp x to [0, w] and y to [0, h]."""
    h, w = clip_size
    boxes = torch.round(boxes)
    return torch.stack([boxes[..., 0].clamp(0.0, w), boxes[..., 1].clamp(0.0, h),
                        boxes[..., 2].clamp(0.0, w), boxes[..., 3].clamp(0.0, h)], dim=-1)


def _anchor_xywh(anchors, device):
    if not torch.is_tensor(anchors):
        anchors = torch.from_numpy(np.asarray(anchors, np.float32))
    return xyxy2xywh(anchors.to(device, torch.float32))


def _scales(delta_scales, device):
    return torch.tensor(delta_scales, dtype=torch.float32).to(device, non_blocking=True)


def _objectness(reg):
    return torch.sigmoid(reg[..., 4]) if reg.shape[-1] == 5 else torch.ones_like(reg[..., 0])


def decode_retinanet(regression, classification, anchors, delta_scales=(0.1, 0.1, 0.2, 0.2),
                     clip_size=None):
    """regression (B, A, 4 | 5), classification (B, A, nc) logits, anchors
    (A, 4) xyxy -> (B, A, 5 + nc)."""
    reg = regression.float()
    a = _anchor_xywh(anchors, reg.device)[None]
    d = reg[..., 0:4] * _scales(delta_scales, reg.device)
    cx = d[..., 0] * a[..., 2] + a[..., 0]
    cy = d[..., 1] * a[..., 3] + a[..., 1]
    w = torch.exp(d[..., 2].clamp(-20.0, 20.0)) * a[..., 2]
    h = torch.exp(d[..., 3].clamp(-20.0, 20.0)) * a[..., 3]
    if clip_size is not None:
        half_w, half_h = w * 0.5, h * 0.5
        xyxy = _round_clip_xyxy(torch.stack([cx - half_w, cy - half_h, cx + half_w,
                                             cy + half_h], dim=-1), clip_size)
        cx = (xyxy[..., 0] + xyxy[..., 2]) * 0.5
        cy = (xyxy[..., 1] + xyxy[..., 3]) * 0.5
        w = xyxy[..., 2] - xyxy[..., 0]
        h = xyxy[..., 3] - xyxy[..., 1]
    cls = torch.sigmoid(classification.float())
    return torch.cat([torch.stack([cx, cy, w, h, _objectness(reg)], dim=-1), cls], dim=-1)


def decode_topk_retinanet(regression, classification, anchors, k: int, conf_threshold,
                          cls_threshold, delta_scales=(0.1, 0.1, 0.2, 0.2), clip_size=None):
    """Fused candidate selection: the score ``obj * sigmoid(max logit)``
    gated (obj >= conf, score > cls_thr), one stable top-k (the index order
    of :func:`decode_retinanet`), then the delta transform of the K winners
    only. Returns boxes (B, K, 4) xyxy, scores (B, K), cls_ids (B, K)."""
    from ..ops.nms import stable_topk

    reg = regression.float()
    obj = _objectness(reg)
    logits = classification.float()
    cls_conf = obj * torch.sigmoid(logits.amax(-1))
    valid = (obj >= conf_threshold) & (cls_conf > cls_threshold)
    score_f, idx_f = stable_topk(torch.where(valid, cls_conf, 0.0), min(k, cls_conf.shape[-1]))

    reg_k = torch.take_along_dim(reg[..., 0:4], idx_f[..., None], dim=1)
    cls_f = torch.take_along_dim(logits, idx_f[..., None], dim=1).argmax(-1)
    ak = _anchor_xywh(anchors, reg.device)[idx_f]  # (B, K, 4)
    d = reg_k * _scales(delta_scales, reg.device)
    cx = d[..., 0] * ak[..., 2] + ak[..., 0]
    cy = d[..., 1] * ak[..., 3] + ak[..., 1]
    hw = torch.exp(d[..., 2].clamp(-20.0, 20.0)) * ak[..., 2] * 0.5
    hh = torch.exp(d[..., 3].clamp(-20.0, 20.0)) * ak[..., 3] * 0.5
    boxes = torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)
    if clip_size is not None:
        boxes = _round_clip_xyxy(boxes, clip_size)
    return boxes, score_f, cls_f.float()
