"""YOLOv8 loss: task-aligned assignment (TAL), CIoU and the distribution
focal loss, the dense form of ``yoloseries_tpu/losses/yolov8.py``.

* DFL decode: softmax over the ``reg`` bins of each side, the expectation
  over bins 1..reg (1-indexed, as the reference; not ``arange(reg)``), as
  [t, b, l, r] distances from the cell centre in grid units;
* candidates: cell centres strictly inside the gt box;
* the alignment metric ``iou^beta * score^alpha`` (6, 0.5) with the clamped
  CIoU and the predicted probability of the gt's class;
* each gt's top-``topk`` cells by metric (every cell equal to the k-th
  value passes), a cell taken by more than one gt goes to the gt of
  largest IoU over all gts (the column is dropped when that gt did not
  take it);
* the class target is the one-hot row times the metric normalized per gt
  (metric * max IoU / max metric), the losses are the class BCE (with the
  focal factor), the score-weighted CIoU and the DFL over the assigned
  cells, each over the total target score, all times B.

Spans (``utils/trace.py``): ``yolov8_loss.decode`` (the DFL decode of every
cell), ``yolov8_loss.assign`` (TAL) and ``yolov8_loss.terms`` (the loss
terms after the assignment).

The grid and the stride of each cell come from each map's own (h, w) and
``strides``. The assignment runs ``image_chunk`` images at a time. Maps are
NCHW (B, 4*reg + nc, H, W) at strides 4/8/16/32; rows are read in the
JAX flat order (y*W + x), stages concatenated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..ops.boxes import tblr2xyxy, xyxy2tblr
from ..utils.trace import span
from .common import bce_with_logits, focal_loss_factor

__all__ = ["YOLOv8LossConfig", "dfl_decode", "flat_maps", "tal_assign", "v8_grid",
           "yolov8_loss"]


@dataclasses.dataclass(frozen=True)
class YOLOv8LossConfig:
    num_class: int
    strides: tuple = (4, 8, 16, 32)
    reg: int = 16
    topk: int = 13
    alpha: float = 0.5  # score exponent
    beta: float = 6.0  # IoU exponent
    iou_loss_scale: float = 7.5
    cls_loss_scale: float = 0.5
    dfl_loss_scale: float = 1.5
    cls_pos_weight: float = 1.0
    use_focal_factor: bool = True
    focal_loss_gamma: float = 1.5
    focal_loss_alpha: float = 0.25
    image_chunk: int = 4  # images assigned at once


def v8_grid(shapes, strides, device=None):
    """Cell centres in grid units (N, 2) [x + 0.5, y + 0.5] and each cell's
    stride (N, 1), stage by stage for maps of ``shapes`` [(h, w), ...],
    built on ``device``."""
    grids, cols = [], []
    for (h, w), s in zip(shapes, strides):
        ys = torch.arange(h, device=device, dtype=torch.float32) + 0.5
        xs = torch.arange(w, device=device, dtype=torch.float32) + 0.5
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grids.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        cols.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(grids), torch.cat(cols)


def flat_maps(stage_preds, dtype=torch.float32):
    """NCHW maps -> (B, N, C) rows in the flat order (y*W + x), stages
    concatenated."""
    return torch.cat([p.to(dtype).flatten(2).transpose(1, 2) for p in stage_preds], dim=1)


def dfl_decode(pred_dfl: torch.Tensor, reg: int) -> torch.Tensor:
    """(..., 4*reg) DFL logits -> (..., 4) [t, b, l, r], the expectation
    over bins 1..reg."""
    p = torch.softmax(pred_dfl.unflatten(-1, (4, reg)), dim=-1)
    project = torch.arange(1, reg + 1, dtype=p.dtype, device=p.device)
    return (p * project).sum(-1)


def _ciou_xyxy(b1, b2, eps=1e-6):
    """Elementwise CIoU of xyxy boxes."""
    w1, h1 = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1]
    w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1]
    inter = ((torch.minimum(b1[..., 2], b2[..., 2]) - torch.maximum(b1[..., 0], b2[..., 0]))
             .clamp_min(0) * (torch.minimum(b1[..., 3], b2[..., 3])
                              - torch.maximum(b1[..., 1], b2[..., 1])).clamp_min(0))
    union = ((w1 * h1).clamp_min(0) + (w2 * h2).clamp_min(0) - inter).clamp_min(eps)
    iou = inter / union
    cw = torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0], b2[..., 0])
    ch = torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1])
    diag = (cw.square() + ch.square()).clamp_min(eps)
    dist = ((b1[..., 2] + b1[..., 0] - b2[..., 2] - b2[..., 0]).square()
            + (b1[..., 3] + b1[..., 1] - b2[..., 3] - b2[..., 1]).square()) / 4.0
    v = (4.0 / math.pi ** 2) * (torch.atan(w1 / h1.clamp_min(eps))
                                - torch.atan(w2 / h2.clamp_min(eps))).square()
    alpha = (v / (1.0 - iou + v).clamp_min(eps)).detach()
    return iou - (dist / diag + v * alpha)


def _tal_chunk(pred_xyxy_px, pred_cls_prob, tar_xyxy, tar_cls, tar_valid, grid_px, cfg):
    """TAL over a chunk of images: pred_xyxy_px (c, N, 4) pixels,
    pred_cls_prob (c, N, nc), targets (c, M, ...), grid_px (N, 2)."""
    m = tar_valid.shape[1]
    n = grid_px.shape[0]
    gx, gy = grid_px[:, 0], grid_px[:, 1]
    l = gx - tar_xyxy[..., 0:1]
    t = gy - tar_xyxy[..., 1:2]
    r = tar_xyxy[..., 2:3] - gx
    b = tar_xyxy[..., 3:4] - gy
    in_gt = (torch.minimum(torch.minimum(l, t), torch.minimum(r, b)) > 1e-9) & tar_valid[..., None]

    iou = _ciou_xyxy(tar_xyxy[:, :, None, :], pred_xyxy_px[:, None, :, :]).clamp_min(0.0)
    iou = torch.where(in_gt, iou, 0.0)  # (c, M, N)
    score = torch.take_along_dim(pred_cls_prob, tar_cls[:, None, :], dim=2).transpose(1, 2)
    score = torch.where(in_gt, score, 0.0)
    metric = iou ** cfg.beta * score ** cfg.alpha

    kth = torch.topk(metric, min(cfg.topk, n), dim=-1).values[..., -1:]
    mask_topk = (metric >= kth.clamp_min(1e-12)) & (metric > 0) & tar_valid[..., None]
    # a cell taken by more than one gt goes to the gt of largest IoU
    winner = torch.arange(m, device=iou.device)[None, :, None] == iou.argmax(1)[:, None, :]
    mask_assign = torch.where(mask_topk.sum(1, keepdim=True) > 1, mask_topk & winner, mask_topk)

    fg = mask_assign.any(1)
    matched_gt = mask_assign.to(torch.uint8).argmax(1)
    metric_m = metric * mask_assign
    iou_m = iou * mask_assign
    norm = (metric_m * iou_m.amax(-1, keepdim=True)
            / (metric_m.amax(-1, keepdim=True) + 1e-9))
    return fg, matched_gt, norm.amax(1)


def tal_assign(pred_xyxy_px, pred_cls_prob, tar_xyxy, tar_cls, tar_valid, grid_px,
               cfg: YOLOv8LossConfig):
    """TAL of a batch, ``cfg.image_chunk`` images at a time. Returns fg
    (B, N) bool, the matched gt slot (B, N) and the normalized metric
    (B, N)."""
    bsz = tar_valid.shape[0]
    step = max(1, min(cfg.image_chunk, bsz))
    outs = [_tal_chunk(pred_xyxy_px[i:i + step], pred_cls_prob[i:i + step],
                       tar_xyxy[i:i + step], tar_cls[i:i + step], tar_valid[i:i + step],
                       grid_px, cfg) for i in range(0, bsz, step)]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def yolov8_loss(stage_preds: Sequence[torch.Tensor], targets: torch.Tensor,
                balances: torch.Tensor, cfg: YOLOv8LossConfig, reduce=None):
    """stage_preds: four NCHW maps (B, 4*reg + nc, H, W); targets (B, M, 6)
    [xmin, ymin, xmax, ymax, cls, img_idx] in input pixels, -1 padded.
    ``balances`` passes through unchanged. Returns (loss_dict, balances).

    ``reduce``: a sum over data-parallel ranks (``parallel/dist.py::
    all_reduce_sum``), for the global batch's loss (the JAX pjit step's).
    Its global terms: the total target score, summed over the ranks before
    its clamp to 1, and the batch that scales every term. Each rank's
    ``loss_dict`` is its share of the global loss (``tar_nums`` its own
    count). TAL assigns each image alone and needs no reduction."""
    bsz = targets.shape[0]
    dev = stage_preds[0].device
    if reduce is not None:
        bsz = reduce(torch.full((), float(bsz), device=dev))
    nc, reg = cfg.num_class, cfg.reg
    with span("yolov8_loss.decode"):
        grids, strides_col = v8_grid([p.shape[2:] for p in stage_preds], cfg.strides, dev)
        grid_px = grids * strides_col
        all_preds = flat_maps(stage_preds)  # (B, N, 4*reg + nc)
        pred_dfl, pred_cls = all_preds[..., :4 * reg], all_preds[..., 4 * reg:]
        pred_xyxy = tblr2xyxy(dfl_decode(pred_dfl, reg), grids)  # grid units
        pred_xyxy_px = pred_xyxy * strides_col

    tar_xyxy = targets[..., 0:4].float()
    tar_valid = targets[..., 4] >= 0
    tar_cls = targets[..., 4].to(torch.int64).clamp(0, nc - 1)

    with span("yolov8_loss.assign"), torch.no_grad():
        fg, matched_gt, norm_metric = tal_assign(pred_xyxy_px, torch.sigmoid(pred_cls),
                                                 tar_xyxy, tar_cls, tar_valid, grid_px, cfg)
    with span("yolov8_loss.terms"):
        fgf = fg.float()
        m_cls = torch.take_along_dim(tar_cls, matched_gt, 1)
        m_box = torch.take_along_dim(tar_xyxy, matched_gt[..., None], 1)
        cls_score = F.one_hot(m_cls, nc).float() * (norm_metric * fgf)[..., None]
        tar_score_sum = cls_score.sum()
        if reduce is not None:
            tar_score_sum = reduce(tar_score_sum.clone())
        tar_score_sum = tar_score_sum.clamp_min(1.0)

        bce = bce_with_logits(pred_cls, cls_score, cfg.cls_pos_weight)
        if cfg.use_focal_factor:
            bce = bce * focal_loss_factor(pred_cls, cls_score, cfg.focal_loss_gamma,
                                          cfg.focal_loss_alpha)
        cls_loss = bce.sum() / tar_score_sum

        box_grid = m_box / strides_col
        weight = cls_score.sum(-1)
        iou_loss = (((1.0 - _ciou_xyxy(pred_xyxy, box_grid)) * weight * fgf).sum()
                    / tar_score_sum)

        tar_tblr = xyxy2tblr(box_grid, grids).clamp(0.0, reg - 1 - 0.01)
        tl = torch.floor(tar_tblr).long()
        wr = tar_tblr - tl
        wl = 1.0 - wr
        logp = torch.log_softmax(pred_dfl.unflatten(-1, (4, reg)), dim=-1)
        ce_l = -torch.take_along_dim(logp, tl[..., None], dim=-1)[..., 0]
        ce_r = -torch.take_along_dim(logp, (tl + 1).clamp_max(reg - 1)[..., None],
                                     dim=-1)[..., 0]
        dfl = ce_l * wl + ce_r * wr
        dfl_loss = ((dfl.mean(-1) * weight * fgf).sum()) / tar_score_sum

        cls_loss = cls_loss * cfg.cls_loss_scale * bsz
        iou_loss = iou_loss * cfg.iou_loss_scale * bsz
        dfl_loss = dfl_loss * cfg.dfl_loss_scale * bsz
    loss_dict = {
        "tot_loss": cls_loss + iou_loss + dfl_loss,
        "cls_loss": cls_loss.detach(),
        "iou_loss": iou_loss.detach(),
        "dfl_loss": dfl_loss.detach(),
        "tar_nums": fgf.sum(),
    }
    return loss_dict, balances
