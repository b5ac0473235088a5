"""The YOLOv5 training loss, written plainly from ultralytics/yolov5
``utils/loss.py::ComputeLoss`` with the recipe's settings.

* Targets: every labelled box of the batch in (image, slot) order, its
  centre and size in grid units of each stage.
* Candidates (``build_targets``): each target with each anchor whose size
  ratio, either way, stays under ``anchor_match_thr``; at its own cell and
  at the neighbours its centre lies within half a cell of (left, up,
  right, down, each only away from the border). Listed with the offset
  slowest, then the anchor, then the target.
* Box: 1 - CIoU of the decoded prediction (``2 sigmoid - 0.5`` for the
  centre, ``(2 sigmoid)^2 x anchor`` for the size) against the target,
  the mean over the candidates; every length of it taken from the boxes'
  corners, where a size below the corners' rounding reads 0.
* Class: binary cross entropy of every class logit against the one-hot
  class (times ``class_smooth_factor``), the mean over candidates x
  classes, where there is more than one class.
* Objectness: binary cross entropy of every cell and anchor against the
  detached CIoU (clamped at 0) written at the candidates' cells, the
  later candidate in the listed order winning a cell; the mean over the
  grid, times the stage's balance.
* With ``use_focal_loss`` each cross entropy is multiplied by the focal
  factor ``(1 - p_t)^gamma`` and the alpha balance.
* Balances: each becomes ``0.9999 b + 0.0001 / (its stage's objectness
  loss)``, then all are divided by the middle stage's; the three sums are
  scaled by their gains and the total by the batch size.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))


def initial_balances(device=None) -> torch.Tensor:
    return torch.tensor([4.0, 1.0, 0.4], dtype=torch.float32, device=device)


def ciou(b1, b2, eps=1e-9):
    """Complete IoU of xywh boxes, taken on their corners (each side, the
    widths and heights of the aspect term too, from the corners, as the
    recipe's loss computes it); the aspect weight carries no gradient."""
    (l1, t1), (r1, d1) = (b1[..., :2] - b1[..., 2:] / 2).unbind(-1), (
        b1[..., :2] + b1[..., 2:] / 2).unbind(-1)
    (l2, t2), (r2, d2) = (b2[..., :2] - b2[..., 2:] / 2).unbind(-1), (
        b2[..., :2] + b2[..., 2:] / 2).unbind(-1)
    w1, h1, w2, h2 = r1 - l1, d1 - t1, r2 - l2, d2 - t2
    inter = ((torch.minimum(r1, r2) - torch.maximum(l1, l2)).clamp_min(0)
             * (torch.minimum(d1, d2) - torch.maximum(t1, t2)).clamp_min(0))
    iou = inter / (w1 * h1 + w2 * h2 - inter).clamp_min(eps)
    cw = torch.maximum(r1, r2) - torch.minimum(l1, l2)
    ch = torch.maximum(d1, d2) - torch.minimum(t1, t2)
    rho2 = ((l1 + r1 - l2 - r2) ** 2 + (t1 + d1 - t2 - d2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w1 / h1.clamp_min(eps))
                              - torch.atan(w2 / h2.clamp_min(eps))) ** 2
    with torch.no_grad():
        alpha = v / (1 - iou + v).clamp_min(eps)
    return iou - (rho2 / (cw ** 2 + ch ** 2).clamp_min(eps) + v * alpha)


def _bce(logits, targets, hyp):
    loss = F.binary_cross_entropy_with_logits(logits, targets, reduction="none")
    if hyp["use_focal_loss"]:
        p = torch.sigmoid(logits)
        p_t = targets * p + (1 - targets) * (1 - p)
        a = hyp["focal_loss_alpha"]
        loss = loss * (targets * a + (1 - targets) * (1 - a)) * (1 - p_t) ** hyp["focal_loss_gamma"]
    return loss


def yolov5_loss(maps, ann, balances, anchors, hyp: dict, nc: int, size: int):
    """maps: raw (B, A * (5 + nc), H, W) of each stage; ann (B, M, 6)
    [x1, y1, x2, y2, cls, row] in input pixels, padding -1; anchors
    (stages, A, 2) in pixels. Returns ({"tot_loss": ...}, new balances)."""
    dev = maps[0].device
    b_all = ann.shape[0]
    bi, mi = torch.nonzero(ann[..., 4] >= 0, as_tuple=True)  # image, then slot
    t = ann[bi, mi]
    cls = t[:, 4].long()
    xy = (t[:, 0:2] + t[:, 2:4]) / 2 / size
    wh = (t[:, 2:4] - t[:, 0:2]) / size
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    na = anchors.shape[1]
    offsets = torch.tensor(OFFSETS, device=dev)
    lbox = lobj = lcls = torch.zeros((), device=dev)
    new_bal = []
    for i, p in enumerate(maps):
        h, w = p.shape[2:]
        p = p.view(b_all, na, 5 + nc, h, w)
        grid = torch.tensor([w, h], dtype=torch.float32, device=dev)
        anc = anchors[i] / (size / w)
        gxy, gwh = xy * grid, wh * grid
        r = gwh[None] / anc[:, None]  # (A, T, 2)
        fits = torch.maximum(r, 1 / r).amax(-1) < hyp["anchor_match_thr"]  # (A, T)
        lo = (gxy % 1 < 0.5) & (gxy > 1)
        hi = ((grid - gxy) % 1 < 0.5) & (grid - gxy > 1)
        near = torch.stack([torch.ones_like(lo[:, 0]), lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]])
        take = near[:, None, :] & fits[None]  # (5, A, T): offset, anchor, target
        o, a, k = torch.nonzero(take, as_tuple=True)  # in that order
        cell = torch.floor(gxy[k] - offsets[o])
        gi = cell[:, 0].long().clamp(0, w - 1)
        gj = cell[:, 1].long().clamp(0, h - 1)
        b = bi[k]
        ps = p[b, a, :, gj, gi]  # (N, 5 + nc)
        tobj = torch.zeros((b_all, na, h, w), device=dev)
        n = len(k)
        if n:
            pbox = torch.cat([torch.sigmoid(ps[:, :2]) * 2 - 0.5,
                              (torch.sigmoid(ps[:, 2:4]) * 2) ** 2 * anc[a]], 1)
            iou = ciou(pbox, torch.cat([gxy[k] - cell, gwh[k]], 1))
            lbox = lbox + (1 - iou).mean()
            # the later candidate wins a cell
            flat = ((b * na + a) * h + gj) * w + gi
            last = torch.full((tobj.numel(),), -1, dtype=torch.long, device=dev)
            last.scatter_reduce_(0, flat, torch.arange(n, device=dev), "amax")
            won = last[flat] == torch.arange(n, device=dev)
            tobj.view(-1)[flat[won]] = iou.detach().clamp_min(0)[won]
            if nc > 1:
                onehot = F.one_hot(cls[k], nc).float() * hyp["class_smooth_factor"]
                lcls = lcls + _bce(ps[:, 5:], onehot, hyp).mean()
        obji = _bce(p[:, :, 4], tobj, hyp).mean() * balances[i]
        new_bal.append(balances[i] * 0.9999 + 0.0001 / obji.detach())
        lobj = lobj + obji
    new_bal = torch.stack(new_bal)
    s = 3 / len(maps)
    tot = (lbox * hyp["iou_loss_scale"] + lobj * hyp["cof_loss_scale"]
           + lcls * hyp["cls_loss_scale"]) * s * b_all
    return {"tot_loss": tot}, new_bal / new_bal[1]
