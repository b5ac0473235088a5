"""Box-format conversions on tensors (last dim 4, any leading dims).

Counterpart of ``yoloseries_tpu/ops/boxes.py`` for the conversions the
YOLOv5 loss uses, with the same operation order. The mAP pass maps boxes
back on the host (``ops/letterbox.py::unletterbox_boxes_np``).
"""

from __future__ import annotations

import torch

__all__ = ["xyxy2xywh", "xywh2xyxy", "xyxy2xywhn"]


def xyxy2xywh(boxes: torch.Tensor) -> torch.Tensor:
    """[xmin, ymin, xmax, ymax] -> [cx, cy, w, h]."""
    xy = (boxes[..., 0:2] + boxes[..., 2:4]) * 0.5
    wh = boxes[..., 2:4] - boxes[..., 0:2]
    return torch.cat([xy, wh], dim=-1)


def xywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[cx, cy, w, h] -> [xmin, ymin, xmax, ymax]."""
    half = boxes[..., 2:4] * 0.5
    return torch.cat([boxes[..., 0:2] - half, boxes[..., 0:2] + half], dim=-1)


def xyxy2xywhn(boxes: torch.Tensor, img_wh) -> torch.Tensor:
    """xyxy -> xywh normalized by the image size ``img_wh = (w, h)``."""
    w, h = img_wh
    dtype = boxes.dtype if boxes.is_floating_point() else torch.float32
    # a non_blocking copy: a blocking one would wait for the card
    scale = torch.tensor([w, h, w, h], dtype=dtype).to(boxes.device, non_blocking=True)
    return xyxy2xywh(boxes) / scale

