"""YOLOX decode, anchor-free: xy = (p + grid) * stride, wh = exp(p) * stride;
counterpart of ``yoloseries_tpu/evaluation/yolox.py``.

The maps are NCHW (B, A*(5+nc), H, W) with A = 1, read in the JAX flat order
((y*W + x)*A + a) as in ``evaluation/yolov5.py``. The grid is built on the
maps' device from each map's own (h, w), so no constant crosses from the
host per call.
"""

from __future__ import annotations

import torch

from .yolov5 import _stage_rows

__all__ = ["decode_topk_yolox", "decode_yolox"]

STRIDES = (8, 16, 32)


def _cells(h: int, w: int, num_anchor: int, device) -> tuple:
    """Grid x and y (f32) of each flat index ((y*W + x)*A + a)."""
    cell = torch.arange(h * w * num_anchor, device=device) // num_anchor
    return (cell % w).float(), (cell // w).float()


def decode_yolox(stage_preds, num_class: int, strides=STRIDES, num_anchor: int = 1):
    """Raw maps -> (B, N, 5+nc) [cx, cy, w, h, obj, cls...] in pixels, obj
    and cls through the sigmoid."""
    no = 5 + num_class
    outs = []
    for pred, stride in zip(stage_preds, strides):
        p = _stage_rows(pred, num_anchor)  # (B, H, W, A, no)
        b, h, w = p.shape[:3]
        ys, xs = torch.meshgrid(torch.arange(h, device=p.device, dtype=torch.float32),
                                torch.arange(w, device=p.device, dtype=torch.float32),
                                indexing="ij")
        grid = torch.stack([xs, ys], dim=-1)[None, :, :, None, :]
        xy = (p[..., 0:2] + grid) * stride
        wh = torch.exp(p[..., 2:4].clamp(-20.0, 20.0)) * stride
        out = torch.cat([xy, wh, torch.sigmoid(p[..., 4:])], dim=-1)
        outs.append(out.reshape(b, h * w * num_anchor, no))
    return torch.cat(outs, dim=1)


def decode_topk_yolox(stage_preds, num_class: int, k: int = 512, conf_threshold=0.25,
                      cls_threshold=0.25, strides=STRIDES, num_anchor: int = 1):
    """Fused candidate selection + sparse decode: the score
    ``sigmoid(obj) * sigmoid(max cls)`` gated (obj >= conf, score > cls_thr)
    on the raw maps, one stable global top-k over the stages (the index
    order of :func:`decode_yolox`), then only the K winners decoded, in f32.
    Returns boxes (B, K, 4) xyxy pixels, scores (B, K), cls_ids (B, K)."""
    from .select import topk_gather

    no = 5 + num_class
    stage_scores, stage_rows, consts = [], [], []
    for pred, stride in zip(stage_preds, strides):
        rows = _stage_rows(pred, num_anchor)
        b, h, w = rows.shape[:3]
        p = rows.reshape(b, h * w * num_anchor, no)
        obj = torch.sigmoid(p[..., 4])
        cls_conf = obj * torch.sigmoid(p[..., 5:].amax(dim=-1))
        valid = (obj >= conf_threshold) & (cls_conf > cls_threshold)
        stage_scores.append(torch.where(valid, cls_conf, 0.0))
        stage_rows.append(p)
        gx, gy = _cells(h, w, num_anchor, p.device)
        consts.append(torch.stack([gx, gy, torch.full_like(gx, float(stride))], dim=1))

    score_f, idx_f, (rows,) = topk_gather(stage_scores, k, [stage_rows])
    ck = torch.cat(consts)[idx_f]  # (B, K, 3)
    cls_f = rows[..., 5:].argmax(dim=-1)
    stride_f = ck[..., 2:3]
    xy = (rows[..., 0:2] + ck[..., 0:2]) * stride_f
    half = torch.exp(rows[..., 2:4].clamp(-20.0, 20.0)) * stride_f * 0.5
    return torch.cat([xy - half, xy + half], dim=-1), score_f, cls_f.float()

