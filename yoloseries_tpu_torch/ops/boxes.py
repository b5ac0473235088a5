"""Box-format conversions on tensors (last dim 4, any leading dims).

Counterpart of ``yoloseries_tpu/ops/boxes.py`` for the conversions the
losses and decoders use, with the same operation order. The mAP pass maps boxes
back on the host (``ops/letterbox.py::unletterbox_boxes_np``).
"""

from __future__ import annotations

import torch

__all__ = ["xyxy2xywh", "xywh2xyxy", "xyxy2xywhn", "tblr2xyxy", "xyxy2tblr"]


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



def tblr2xyxy(tblr: torch.Tensor, grid_xy: torch.Tensor) -> torch.Tensor:
    """[t, b, l, r] distances from grid points -> xyxy. tblr (..., N, 4);
    grid_xy (N, 2), or any shape that broadcasts with tblr's."""
    t, b, l, r = tblr.unbind(-1)
    gx, gy = grid_xy[..., 0], grid_xy[..., 1]
    return torch.stack([gx - l, gy - t, gx + r, gy + b], dim=-1)


def xyxy2tblr(xyxy: torch.Tensor, grid_xy: torch.Tensor) -> torch.Tensor:
    """xyxy -> [t, b, l, r] distances from grid points."""
    xmin, ymin, xmax, ymax = xyxy.unbind(-1)
    gx, gy = grid_xy[..., 0], grid_xy[..., 1]
    return torch.stack([gy - ymin, ymax - gy, gx - xmin, xmax - gx], dim=-1)
