"""The YOLOv8 training loss as YOLOSeries writes it (yl-jiang/YOLOSeries
``loss/yolov8_loss.py:12-410``): task-aligned assignment (TAL), the focal
class BCE, the score-weighted CIoU and the distribution focal loss (DFL),
written plainly from that description, one image at a time over its own
boxes (no padded gt slots), in f32.

* Decode (``families/yolov8.py``): each side's distance is the expectation
  of its softmax over the bin values 1..reg, **not 0..reg-1**, while the
  DFL's targets index the bins from 0 (YOLOSeries' own mismatch, kept).
* Candidates of a gt: the cells whose centre (in pixels) lies **strictly**
  inside its box; a centre on an edge is not one.
* Alignment of a gt and a candidate: ``iou^beta x score^alpha`` (beta 6,
  alpha 0.5), the IoU the CIoU of the gt and the predicted box in pixels
  clamped at 0, the score the predicted probability of the gt's class;
  0 elsewhere.
* Top-k: each gt takes its cells whose alignment is at least its k-th
  largest (k 13) and above 0, so **every cell equal to the k-th passes**.
* A cell taken by more than one gt goes to the gt of largest IoU with it
  (the first such gt where two are equal), and is **dropped** where that gt
  did not take it.
* Class target of a foreground cell: the one-hot row of its gt's class times
  ``alignment x (the gt's largest IoU over its cells) / (the gt's largest
  alignment over its cells + 1e-9)``; 0 elsewhere.
* Terms, each **over the total class target of the batch clamped to 1,
  then times the batch size** B: the class BCE over every cell and class
  with the focal factor ``(1 - p_t)^gamma`` and the alpha balance (gamma
  1.5, alpha 0.25); ``1 - CIoU`` of the predicted box and the gt (in cells)
  weighted by the cell's target; the DFL of each side's target distance,
  clamped to [0, reg - 1.01], as the cross entropy at the bin below and the
  bin above weighted by nearness, the mean of the four sides weighted by the
  cell's target. Scaled by cls 0.5, iou 7.5, dfl 1.5 (the recipe's).

CIoU: ``IoU - centre distance^2 / enclosing diagonal^2 - a v`` with ``v =
4 / pi^2 (atan(w_gt / h_gt) - atan(w / h))^2`` and ``a = v / (1 - IoU +
v)`` taken without its gradient; eps 1e-7 in the heights, the union and
the diagonal.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-7
NORM_EPS = 1e-9


def side_expectation(logits, reg):
    """(..., 4 x reg) DFL logits -> (..., 4) [t, b, l, r] in cells: the
    expectation of each side's softmax over the bin values 1..reg."""
    p = torch.softmax(logits.reshape(*logits.shape[:-1], 4, reg), -1)
    return (p * torch.arange(1, reg + 1, dtype=p.dtype, device=p.device)).sum(-1)


def cells(maps, map_strides):
    """Every cell of the maps in the flat order: (centres (N, 2) in grid
    units, strides (N, 1)), stages in stride order."""
    centres, strides = [], []
    for m, s in zip(maps, map_strides):
        h, w = m.shape[2:]
        ys, xs = torch.meshgrid(torch.arange(h, device=m.device), torch.arange(w, device=m.device),
                                indexing="ij")
        centres.append(torch.stack([xs, ys], -1).reshape(-1, 2).float() + 0.5)
        strides.append(torch.full((h * w, 1), float(s), device=m.device))
    return torch.cat(centres), torch.cat(strides)


def boxes_in_cells(dist, centres):
    """[t, b, l, r] distances from the centres -> xyxy, both in grid units."""
    t, b, l, r = dist.unbind(-1)
    cx, cy = centres[..., 0], centres[..., 1]
    return torch.stack([cx - l, cy - t, cx + r, cy + b], -1)


def rows(maps):
    """The maps as rows (B, N, C) in the flat order."""
    return torch.cat([m.float().flatten(2).transpose(1, 2) for m in maps], 1)


def ciou(a, b):
    """Elementwise CIoU of xyxy boxes ``a`` (the gt) and ``b``."""
    w1, h1 = a[..., 2] - a[..., 0], (a[..., 3] - a[..., 1]).clamp_min(EPS)
    w2, h2 = b[..., 2] - b[..., 0], (b[..., 3] - b[..., 1]).clamp_min(EPS)
    iw = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp_min(0)
    ih = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp_min(0)
    inter = iw * ih
    iou = inter / (w1 * h1 + w2 * h2 - inter + EPS)
    cw = torch.maximum(a[..., 2], b[..., 2]) - torch.minimum(a[..., 0], b[..., 0])
    ch = torch.maximum(a[..., 3], b[..., 3]) - torch.minimum(a[..., 1], b[..., 1])
    rho2 = ((a[..., 0] + a[..., 2] - b[..., 0] - b[..., 2]) ** 2
            + (a[..., 1] + a[..., 3] - b[..., 1] - b[..., 3]) ** 2) / 4
    v = 4 / math.pi ** 2 * (torch.atan(w1 / h1) - torch.atan(w2 / h2)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + EPS))
    return iou - (rho2 / (cw ** 2 + ch ** 2 + EPS) + v * alpha)


@torch.no_grad()
def tal(pred_px, cls_prob, gt_px, gt_cls, centres_px, hyp):
    """TAL of one image over its G boxes: (fg (N,) bool, the gt of each cell
    (N,), the class target's scale of each cell (N,), 0 off the foreground).
    pred_px (N, 4), cls_prob (N, nc), gt_px (G, 4), gt_cls (G,) long,
    centres_px (N, 2)."""
    cx, cy = centres_px[:, 0], centres_px[:, 1]
    inside = torch.stack([cx[None] - gt_px[:, 0:1], cy[None] - gt_px[:, 1:2],
                          gt_px[:, 2:3] - cx[None], gt_px[:, 3:4] - cy[None]], -1).amin(-1) > 0
    iou = torch.where(inside, ciou(gt_px[:, None], pred_px[None]).clamp_min(0), 0.0)  # (G, N)
    score = torch.where(inside, cls_prob[:, gt_cls].T, 0.0)
    align = iou ** hyp["beta"] * score ** hyp["alpha"]
    k = min(hyp["topk"], align.shape[1])
    kth = torch.topk(align, k, dim=1).values[:, -1:]
    taken = (align >= kth) & (align > 0)
    winner = iou.argmax(0)  # the first gt of largest IoU with each cell
    own = torch.arange(len(gt_px), device=iou.device)[:, None] == winner[None]
    shared = taken.sum(0, keepdim=True) > 1
    taken = taken & (~shared | own)
    fg = taken.any(0)
    gt_of = taken.int().argmax(0)
    best_align = torch.where(taken, align, 0.0).amax(1)
    best_iou = torch.where(taken, iou, 0.0).amax(1)
    scale = align * (best_iou / (best_align + NORM_EPS))[:, None]
    return fg, gt_of, torch.where(taken, scale, 0.0).sum(0)


def yolov8_loss(maps, ann, hyp, cfg):
    """maps: the four raw maps (B, 4 reg + nc, H, W); ann (B, M, 6) [x1, y1,
    x2, y2, cls, row] in input pixels, -1 padded. Returns the loss dict."""
    reg, nc = cfg["reg"], cfg["nc"]
    b = maps[0].shape[0]
    r = rows(maps)
    centres, strides = cells(maps, cfg["strides"])
    dfl_logits, cls_logits = r[..., :4 * reg], r[..., 4 * reg:]
    pred = boxes_in_cells(side_expectation(dfl_logits, reg), centres)  # cells
    target = torch.zeros_like(cls_logits)
    iou_sum = dfl_sum = r.new_zeros(())
    n_fg = 0
    for i in range(b):
        valid = ann[i, :, 4] >= 0
        gt_px, gt_cls = ann[i, valid, :4].float(), ann[i, valid, 4].long()
        if not len(gt_px):
            continue
        fg, gt_of, scale = tal(pred[i].detach() * strides, torch.sigmoid(cls_logits[i].detach()),
                               gt_px, gt_cls, centres * strides, hyp)
        target[i, fg] = F.one_hot(gt_cls[gt_of[fg]], nc).float() * scale[fg, None]
        n_fg += int(fg.sum())
        w = scale[fg]
        gt_cells = gt_px[gt_of[fg]] / strides[fg]
        iou_sum = iou_sum + ((1 - ciou(gt_cells, pred[i, fg])) * w).sum()
        c = centres[fg]
        dist = torch.stack([c[:, 1] - gt_cells[:, 1], gt_cells[:, 3] - c[:, 1],
                            c[:, 0] - gt_cells[:, 0], gt_cells[:, 2] - c[:, 0]], -1)
        dist = dist.clamp(0, reg - 1.01)
        left = dist.floor()
        logp = torch.log_softmax(dfl_logits[i, fg].reshape(-1, 4, reg), -1)
        ce_left = -logp.gather(-1, left.long()[..., None])[..., 0]
        ce_right = -logp.gather(-1, left.long()[..., None] + 1)[..., 0]
        dfl = ce_left * (left + 1 - dist) + ce_right * (dist - left)
        dfl_sum = dfl_sum + (dfl.mean(-1) * w).sum()
    total = target.sum().clamp_min(1.0)
    p = torch.sigmoid(cls_logits)
    p_t = target * p + (1 - target) * (1 - p)
    bce = F.binary_cross_entropy_with_logits(
        cls_logits, target, reduction="none",
        pos_weight=torch.tensor(hyp["cls_pos_weight"], device=target.device))
    if hyp["use_focal_loss"]:
        bce = bce * (1 - p_t) ** hyp["focal_loss_gamma"] * (
            target * hyp["focal_loss_alpha"] + (1 - target) * (1 - hyp["focal_loss_alpha"]))
    cls_loss = bce.sum() / total * hyp["cls_loss_scale"] * b
    iou_loss = iou_sum / total * hyp["iou_loss_scale"] * b
    dfl_loss = dfl_sum / total * hyp["dfl_loss_scale"] * b
    return {"tot_loss": cls_loss + iou_loss + dfl_loss, "cls_loss": cls_loss.detach(),
            "iou_loss": iou_loss.detach(), "dfl_loss": dfl_loss.detach(),
            "tar_nums": torch.tensor(float(n_fg))}
