"""FCOS decode: boxes are the location's centre -/+ ltrb * stride, scores
the centerness times the class probability; counterpart of
``yoloseries_tpu/evaluation/fcos.py``. Rows follow the shared postprocess
contract [cx, cy, w, h, obj = sigmoid(ctr), cls...]; the maps are NCHW
(B, nc | 4 | 1, H, W) per level, read row-major, level after level.

Each level's cells and stride (8, 16, ..., 128) are its map's own, as the
loss takes them, so maps of any size decode on their own grid; the JAX
package divides the family's ``input_size`` by the map's height, the same
at inputs that are multiples of 128 only.
"""

from __future__ import annotations

import torch

from ..losses.fcos import level_grid

__all__ = ["STRIDES", "decode_fcos", "decode_topk_fcos"]

STRIDES = (8, 16, 32, 64, 128)


def decode_fcos(cls_fms, reg_fms, ctr_fms, strides=STRIDES):
    """Per-level maps -> (B, N, 5 + nc) pixels, N = sum_l H_l * W_l."""
    outs = []
    for cls_l, reg_l, ctr_l, stride in zip(cls_fms, reg_fms, ctr_fms, strides):
        b, nc, h, w = cls_l.shape
        stride = float(stride)
        grid = level_grid(h, w, stride, cls_l.device)
        reg = reg_l.float().permute(0, 2, 3, 1).reshape(b, h * w, 4) * stride
        x1, y1 = grid[None, :, 0] - reg[..., 0], grid[None, :, 1] - reg[..., 1]
        x2, y2 = grid[None, :, 0] + reg[..., 2], grid[None, :, 1] + reg[..., 3]
        obj = torch.sigmoid(ctr_l.float().reshape(b, h * w))
        cls = torch.sigmoid(cls_l.float().permute(0, 2, 3, 1).reshape(b, h * w, nc))
        outs.append(torch.cat([torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1,
                                            obj], dim=-1), cls], dim=-1))
    return torch.cat(outs, dim=1)


def decode_topk_fcos(cls_fms, reg_fms, ctr_fms, k: int, conf_threshold, cls_threshold,
                     strides=STRIDES):
    """Fused candidate selection: the score ``sigmoid(ctr) * sigmoid(max
    cls logit)`` gated (obj >= conf, score > cls_thr) per level, one stable
    global top-k over the levels (the index order of :func:`decode_fcos`),
    then the ltrb transform of the K winners only. Returns boxes (B, K, 4)
    xyxy, scores (B, K), cls_ids (B, K)."""
    from .select import topk_gather

    scores, cls_rows, reg_rows, consts = [], [], [], []
    for cls_l, reg_l, ctr_l, stride in zip(cls_fms, reg_fms, ctr_fms, strides):
        b, nc, h, w = cls_l.shape
        stride = float(stride)
        logits = cls_l.float().permute(0, 2, 3, 1).reshape(b, h * w, nc)
        obj = torch.sigmoid(ctr_l.float().reshape(b, h * w))
        cls_conf = obj * torch.sigmoid(logits.amax(-1))
        valid = (obj >= conf_threshold) & (cls_conf > cls_threshold)
        scores.append(torch.where(valid, cls_conf, 0.0))
        cls_rows.append(logits)
        reg_rows.append(reg_l.float().permute(0, 2, 3, 1).reshape(b, h * w, 4))
        grid = level_grid(h, w, stride, cls_l.device)
        consts.append(torch.cat([grid, torch.full_like(grid[:, :1], float(stride))], dim=1))

    score_f, idx_f, (cls_k, reg_k) = topk_gather(scores, k, [cls_rows, reg_rows])
    ck = torch.cat(consts)[idx_f]  # (B, K, 3): centre x, centre y, stride
    ltrb = reg_k * ck[..., 2:3]
    boxes = torch.stack([ck[..., 0] - ltrb[..., 0], ck[..., 1] - ltrb[..., 1],
                         ck[..., 0] + ltrb[..., 2], ck[..., 1] + ltrb[..., 3]], dim=-1)
    return boxes, score_f, cls_k.argmax(-1).float()
