"""IoU family on tensors.

``pairwise_iou`` contracts (..., N, 4) x (..., M, 4) -> (..., N, M) with the
union clipped at 1e-9 (zero-area boxes -> 0). ``iou``, ``giou``, ``diou`` and
``ciou`` are elementwise over broadcastable (..., 4) xyxy boxes, with the
eps placements of ``yoloseries_tpu/ops/iou.py`` (iou 1e-9, giou and diou
1e-6, diou clipped to [-1, 1], ciou 1e-9 with the arctan aspect term and
``alpha`` detached).
"""

from __future__ import annotations

import math

import torch

__all__ = ["pairwise_iou", "iou", "giou", "diou", "ciou"]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU, xyxy format."""
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])

    lt = torch.maximum(boxes1[..., :, None, 0:2], boxes2[..., None, :, 0:2])
    rb = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp_min(1e-9)


def _inter_union(boxes1, boxes2):
    lt = torch.maximum(boxes1[..., 0:2], boxes2[..., 0:2])
    rb = torch.minimum(boxes1[..., 2:4], boxes2[..., 2:4])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    return inter, area1 + area2 - inter


def _enclosing_wh(boxes1, boxes2):
    c = (torch.maximum(boxes1[..., 2:4], boxes2[..., 2:4])
         - torch.minimum(boxes1[..., 0:2], boxes2[..., 0:2]))
    return c[..., 0], c[..., 1]


def _center_dist2(boxes1, boxes2):
    d = (boxes1[..., 0:2] + boxes1[..., 2:4]) * 0.5 - (boxes2[..., 0:2] + boxes2[..., 2:4]) * 0.5
    return d[..., 0] ** 2 + d[..., 1] ** 2


def iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU."""
    inter, union = _inter_union(boxes1, boxes2)
    return inter / union.clamp_min(1e-9)


def giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise Generalized IoU (eps 1e-6)."""
    inter, union = _inter_union(boxes1, boxes2)
    i = inter / union.clamp_min(1e-6)
    cw, ch = _enclosing_wh(boxes1, boxes2)
    c_area = cw * ch
    return i - (c_area - union).abs() / c_area.clamp_min(1e-6).abs()


def diou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise Distance IoU (eps 1e-6), clipped to [-1, 1]."""
    inter, union = _inter_union(boxes1, boxes2)
    i = inter / union.clamp_min(1e-6)
    cw, ch = _enclosing_wh(boxes1, boxes2)
    c_diag = cw**2 + ch**2
    return (i - _center_dist2(boxes1, boxes2) / c_diag.clamp_min(1e-6)).clamp(-1.0, 1.0)


def ciou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise Complete IoU; the aspect weight ``alpha`` carries no
    gradient."""
    eps = 1e-9
    w1 = boxes1[..., 2] - boxes1[..., 0]
    h1 = boxes1[..., 3] - boxes1[..., 1]
    w2 = boxes2[..., 2] - boxes2[..., 0]
    h2 = boxes2[..., 3] - boxes2[..., 1]

    inter, union = _inter_union(boxes1, boxes2)
    i = inter / union.clamp_min(eps)

    cw, ch = _enclosing_wh(boxes1, boxes2)
    c_diag = cw**2 + ch**2

    dist = _center_dist2(boxes1, boxes2)

    v = (4.0 / math.pi**2) * (
        torch.atan(w1 / h1.clamp_min(eps)) - torch.atan(w2 / h2.clamp_min(eps))
    ) ** 2
    alpha = (v / (1.0 - i + v).clamp_min(eps)).detach()
    return i - (dist / c_diag.clamp_min(eps) + v * alpha)
