"""YOLOv8 decode: DFL expectation -> [t, b, l, r] -> xyxy * stride, sigmoid
classes; counterpart of ``yoloseries_tpu/evaluation/yolov8.py``. There is
no objectness: the dense rows carry obj = 1, so conf is the class
probability.

The grid and the stride of each cell come from each map's own (h, w), as
``decode_yolox`` does. The JAX package builds them from the family's
``input_size`` instead, which gives the same cells at that size only: maps
of any other size make its dense decode raise and its fused selection read
cells of the wrong layout.

Maps are NCHW (B, 4*reg + nc, H, W) at strides 4/8/16/32, read in the flat
order (y*W + x), stages concatenated.
"""

from __future__ import annotations

import torch

from ..losses.yolov8 import dfl_decode, flat_maps, v8_grid
from ..ops.boxes import tblr2xyxy

__all__ = ["decode_topk_yolov8", "decode_yolov8"]

STRIDES = (4, 8, 16, 32)


def decode_yolov8(stage_preds, num_class: int, strides=STRIDES, reg: int = 16):
    """Raw maps -> (B, N, 5+nc) [cx, cy, w, h, 1, cls...] in pixels."""
    grids, strides_col = v8_grid([p.shape[2:] for p in stage_preds], strides,
                                 stage_preds[0].device)
    all_preds = flat_maps(stage_preds)
    xyxy = tblr2xyxy(dfl_decode(all_preds[..., :4 * reg], reg), grids) * strides_col
    xy = (xyxy[..., 0:2] + xyxy[..., 2:4]) * 0.5
    wh = xyxy[..., 2:4] - xyxy[..., 0:2]
    return torch.cat([xy, wh, torch.ones_like(xy[..., 0:1]),
                      torch.sigmoid(all_preds[..., 4 * reg:])], dim=-1)


def decode_topk_yolov8(stage_preds, num_class: int, k: int = 512, conf_threshold=0.25,
                       cls_threshold=0.25, strides=STRIDES, reg: int = 16):
    """Fused candidate selection + sparse DFL decode: the score
    ``sigmoid(max cls)`` gated as the dense path gates obj = 1
    (1 >= conf and score > cls_thr), one stable global top-k over the
    stages (the index order of :func:`decode_yolov8`), then the DFL
    expectation of the K winners only, in f32. Returns boxes (B, K, 4) xyxy
    pixels, scores (B, K), cls_ids (B, K)."""
    from .select import topk_gather

    grids, strides_col = v8_grid([p.shape[2:] for p in stage_preds], strides,
                                 stage_preds[0].device)
    stage_scores, stage_rows = [], []
    for pred in stage_preds:
        p = pred.float().flatten(2).transpose(1, 2)  # (B, h*w, C)
        cls_conf = torch.sigmoid(p[..., 4 * reg:].amax(dim=-1))
        valid = (1.0 >= conf_threshold) & (cls_conf > cls_threshold)
        stage_scores.append(torch.where(valid, cls_conf, 0.0))
        stage_rows.append(p)

    score_f, idx_f, (rows,) = topk_gather(stage_scores, k, [stage_rows])
    cls_f = rows[..., 4 * reg:].argmax(dim=-1)
    boxes = tblr2xyxy(dfl_decode(rows[..., :4 * reg], reg), grids[idx_f]) * strides_col[idx_f]
    return boxes, score_f, cls_f.float()

