"""The YOLOX training loss with SimOTA, written plainly from Megvii's
``yolox/models/yolo_head.py`` (``get_assignments``,
``dynamic_k_matching``, ``get_losses``) in the variant the recipe trains,
one image and one stage at a time.

* Candidates of an image: the cell centres inside some gt box (where none
  is, each gt's nearest cell centre), or inside the square of
  ``center_radius`` pixels around some gt centre (where none is, the box
  candidates).
* Cost of a gt and a candidate: the class cost, then ``3 x -log(IoU +
  eps)``, then 1e5 where the centre is not inside both that gt's box and
  its square. The class cost is the binary cross entropy of a 0.5
  probability (the recipe computes it from zeroed logits) against the gt's
  one-hot row, summed over the classes.
* Dynamic k of a gt: the sum of its ``topk`` largest IoUs with the
  candidates, truncated, at least 1. Each gt takes its k cheapest
  candidates (equal costs in position order); a position taken by more
  than one gt goes to the gt of least cost over all gts.
* Losses of a stage over its foreground count: the IoU loss (``iou_type``)
  and the L1 of the raw offsets to the matched gt; the class cross entropy
  against the one-hot row times the IoU (with its gradient); the
  confidence cross entropy over every position, times the stage's balance,
  which becomes ``0.9999 b + 0.0001 / (its confidence loss)`` (all then
  divided by the middle stage's). With ``use_focal_loss`` each cross
  entropy takes the focal factor.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-9
BIG = 1e5


def initial_balances(device=None) -> torch.Tensor:
    return torch.tensor([4.0, 1.0, 0.4], dtype=torch.float32, device=device)


def iou_xywh(a, b):
    """IoU of xywh boxes over ``area a + area b - intersection``."""
    lt = torch.maximum(a[..., :2] - a[..., 2:] / 2, b[..., :2] - b[..., 2:] / 2)
    rb = torch.minimum(a[..., :2] + a[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2)
    inter = (rb - lt).clamp_min(0).prod(-1)
    area = (a[..., 2] * a[..., 3]).clamp_min(0) + (b[..., 2] * b[..., 3]).clamp_min(0)
    return inter / (area - inter + EPS)


def iou_loss(p, t, kind):
    """1 - IoU^2, 1 - GIoU or 1 - CIoU of xywh boxes."""
    iou = iou_xywh(p, t)
    if kind == "iou":
        return 1 - iou ** 2
    wh = ((torch.maximum(p[..., :2] + p[..., 2:] / 2, t[..., :2] + t[..., 2:] / 2)
           - torch.minimum(p[..., :2] - p[..., 2:] / 2, t[..., :2] - t[..., 2:] / 2))
          .clamp_min(0))
    if kind == "giou":
        area = (p[..., 2] * p[..., 3]).clamp_min(0) + (t[..., 2] * t[..., 3]).clamp_min(0)
        hull = wh[..., 0] * wh[..., 1]
        return 1 - (iou - (hull - area).abs() / (hull + EPS)).clamp(-1, 1)
    rho2 = ((p[..., :2] - t[..., :2]) ** 2).sum(-1)
    v = (4 / math.pi ** 2) * (torch.atan(p[..., 2] / p[..., 3].clamp_min(EPS))
                              - torch.atan(t[..., 2] / t[..., 3].clamp_min(EPS))) ** 2
    with torch.no_grad():
        alpha = v / (1 - iou + v).clamp_min(EPS)
    return 1 - (iou - rho2 / ((wh ** 2).sum(-1) + EPS) - v * alpha)


def _bce(logits, targets, hyp):
    loss = F.binary_cross_entropy_with_logits(logits, targets, reduction="none")
    if hyp["use_focal_loss"]:
        p = torch.sigmoid(logits)
        p_t = targets * p + (1 - targets) * (1 - p)
        a = hyp["focal_loss_alpha"]
        loss = loss * (targets * a + (1 - targets) * (1 - a)) * (1 - p_t) ** hyp["focal_loss_gamma"]
    return loss


def simota(gt, onehot, box, ctr, hyp):
    """One image at one stage: gt (m, 4) xywh, onehot (m, nc), box (P, 4)
    the decoded predictions, ctr (P, 2) cell centres, all in pixels.
    Returns (fg (P,) bool, the matched gt (P,) long)."""
    m, n_pos = len(gt), len(ctr)
    if m == 0:
        return torch.zeros(n_pos, dtype=torch.bool, device=box.device), \
            torch.zeros(n_pos, dtype=torch.long, device=box.device)
    d = ctr[None] - gt[:, None, :2]  # (m, P, 2): centre minus gt centre
    in_box = (gt[:, None, 2:] / 2 - d.abs()).amin(-1) > EPS
    if in_box.any():
        box_all = in_box.any(0)
    else:
        box_all = torch.zeros(n_pos, dtype=torch.bool, device=box.device)
        box_all[(d ** 2).sum(-1).argmin(1)] = True
    r = hyp["center_radius"]
    in_ctr = (r - d.abs()).amin(-1) > EPS
    ctr_all = in_ctr.any(0) if in_ctr.any() else box_all
    cand = box_all | ctr_all
    iou = torch.where(cand, iou_xywh(gt[:, None], box[None]), 0.0)
    half = torch.full((), 0.5, device=box.device)
    cls_cost = -(onehot * torch.log(half) + (1 - onehot) * torch.log(half)).sum(-1)
    cost = cls_cost[:, None] + 3 * -torch.log(iou + EPS) + (~(in_box & in_ctr)).float() * BIG
    cost = torch.where(cand, cost, math.inf)
    k = torch.topk(iou, min(hyp["topk"], n_pos), dim=1).values.sum(1).int().clamp(1, n_pos)
    rank = torch.empty_like(cost, dtype=torch.long)
    rank.scatter_(1, torch.sort(cost, dim=1, stable=True).indices,
                  torch.arange(n_pos, device=box.device).expand(m, n_pos))
    finite = torch.isfinite(cost)
    pick = (rank < k[:, None]) & finite
    least = torch.where(finite, cost, 1e30).argmin(0)  # (P,)
    shared = pick.sum(0) > 1
    pick[:, shared] = (torch.arange(m, device=box.device)[:, None] == least[None])[:, shared] \
        & finite[:, shared]
    return pick.any(0), pick.float().argmax(0)


def yolox_loss(maps, ann, balances, hyp: dict, nc: int, size: int):
    """maps: raw (B, 5 + nc, H, W) of each stage; ann (B, M, 6) [x1, y1, x2,
    y2, cls, row] in input pixels, padding -1. Returns ({"tot_loss": ...},
    new balances)."""
    dev = maps[0].device
    valid = ann[..., 4] >= 0
    gt = torch.cat([(ann[..., :2] + ann[..., 2:4]) / 2, ann[..., 2:4] - ann[..., :2]], -1)
    onehot = F.one_hot(ann[..., 4].long().clamp(0, nc - 1), nc).float() * hyp[
        "class_smooth_factor"]
    total = {k: torch.zeros((), device=dev) for k in ("iou", "l1", "cof", "cls")}
    new_bal = []
    for i, p in enumerate(maps):
        b, _, h, w = p.shape
        stride = size / h
        p = p.permute(0, 2, 3, 1).reshape(b, h * w, 5 + nc)  # positions y * W + x
        ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                                torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
        grid = torch.stack([xs, ys], -1).reshape(-1, 2)
        box = torch.cat([(p[..., :2] + grid) * stride,
                         torch.exp(p[..., 2:4].clamp(-20, 20)) * stride], -1)
        with torch.no_grad():
            assigned = [simota(gt[j][valid[j]], onehot[j][valid[j]], box[j], (grid + 0.5) * stride,
                               hyp) for j in range(b)]
        fg = torch.stack([a[0] for a in assigned])
        idx = torch.stack([a[1] for a in assigned])  # among the image's valid gts, in slot order
        tgt = torch.stack([gt[j][valid[j]][idx[j]] if valid[j].any() else gt[j][:1].expand(
            h * w, 4) for j in range(b)])
        tcls = torch.stack([onehot[j][valid[j]][idx[j]] if valid[j].any() else onehot[j][:1]
                            .expand(h * w, nc) for j in range(b)])
        fgf = fg.float()
        n_fg = fgf.sum().clamp_min(1)
        total["iou"] = total["iou"] + (iou_loss(box, tgt, hyp["iou_type"]) * fgf).sum() / n_fg
        if hyp["use_l1"]:
            l1_t = torch.cat([tgt[..., :2] / stride - grid, torch.log(tgt[..., 2:] / stride + 1e-16)],
                             -1)
            total["l1"] = total["l1"] + ((p[..., :4] - l1_t).abs().mean(-1) * fgf).sum() / n_fg
        cof = _bce(p[..., 4], fgf, hyp).sum() / n_fg * balances[i]
        new_bal.append(balances[i] * 0.9999 + 0.0001 / cof.detach())
        total["cof"] = total["cof"] + cof
        soft = tcls * torch.where(fg, iou_xywh(tgt, box[..., :4]), 0.0)[..., None]
        total["cls"] = total["cls"] + (_bce(p[..., 5:], soft, hyp).mean(-1) * fgf).sum() / n_fg
    new_bal = torch.stack(new_bal)
    tot = (total["iou"] * hyp["iou_loss_scale"] + total["cls"] * hyp["cls_loss_scale"]
           + total["cof"] * hyp["cof_loss_scale"] + total["l1"] * hyp["l1_loss_scale"])
    return {"tot_loss": tot}, new_bal / new_bal[1]
