"""YOLOX loss: dense fixed-shape SimOTA, the form of
``yoloseries_tpu/losses/yolox.py``.

Per image and stage the assigner builds an (M gt slots x P positions)
lattice: candidate gating (the cell centre inside the gt box, or inside the
square of ``center_radius`` pixels around its centre; where no centre lies
in any box, the nearest cell of each gt), the cost
``(cls_cost + 3 * -log(iou + eps)) + 1e5 * !pair`` (pair: inside the box
and the square), ``inf`` on dead columns and padded gts, dynamic k from the
sum of each gt's top-``topk`` IoUs, each gt's k cheapest columns (equal
costs lowest index first, as JAX's stable argsort ranks them), and a column
picked by more than one gt goes to the gt of least cost over all gts.

Two forms of the JAX lattice that keep its values:

* the rank test ``rank(cost) < k`` reads the k-th smallest cost of the row
  (``torch.topk``; k <= ``topk`` since IoUs are at most 1) and takes the
  columns below it, then the equal ones in index order up to k: the stable
  argsort's ranks without sorting all P columns;
* with ``use_pred_cls_in_cost=False`` (the default: the reference builds
  the cost from a copy whose cof/cls logits are zero, so every probability
  is 0.5) the class cost does not vary along P and is one (M,) column per
  image, with no (M, P, nc) temporary. With ``True`` (the upstream YOLOX
  cost, sigmoid of the real logits) the (M, P, nc) terms are built for a
  slice of gts at a time.

The batch is assigned ``image_chunk`` images at a time, each chunk at once,
so the lattices of all images never exist together. The loss then takes
L1 on the raw offsets, a CIoU (or IoU / GIoU) regression and the class BCE
over the assigned positions, and the confidence BCE over all positions,
each over the stage's foreground count; the confidence balances tune
themselves by an EMA, as in the JAX package.

Maps are NCHW (B, A*(5+nc), H, W), channels [x, y, w, h, cof, cls...], A=1;
rows are read in the JAX flat order ((y*W + x)*A + a).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.boxes import xywh2xyxy
from .common import bce_with_logits, focal_loss_factor

__all__ = ["YOLOXLossConfig", "simota_assign", "yolox_initial_balances", "yolox_loss"]

EPS = 1e-9
BIG = 1e5  # the cost of a column outside the box-and-square pair
CLS_COST_ELEMENTS = 1 << 24  # (images x gts x P x nc) per slice of the predicted-class cost


@dataclasses.dataclass(frozen=True)
class YOLOXLossConfig:
    num_class: int
    input_size: tuple = (640, 640)
    strides: tuple = (8, 16, 32)
    topk: int = 13
    center_radius: float = 3.0  # in pixels, as the reference
    iou_type: str = "ciou"
    use_l1: bool = True
    iou_loss_scale: float = 5.0
    cls_loss_scale: float = 1.0
    cof_loss_scale: float = 1.0
    l1_loss_scale: float = 1.0
    cls_pos_weight: float = 1.0
    cof_pos_weight: float = 1.0
    class_smooth_factor: float = 1.0
    use_focal_loss: bool = False
    focal_loss_gamma: float = 1.5
    focal_loss_alpha: float = 0.25
    image_chunk: int = 8  # images assigned at once
    # False: the reference's zeroed-logit cost (every probability 0.5);
    # True: the real cls/cof logits (upstream YOLOX)
    use_pred_cls_in_cost: bool = False


def yolox_initial_balances(num_stages: int = 3, device=None) -> torch.Tensor:
    vals = [4.0, 1.0, 0.4] if num_stages == 3 else [4.0, 1.0, 0.4, 0.1]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def _iou_xywh(box1, box2, eps=EPS):
    """IoU of xywh boxes over ``area1 + area2 - inter``."""
    b1, b2 = xywh2xyxy(box1), xywh2xyxy(box2)
    lt = torch.maximum(b1[..., 0:2], b2[..., 0:2])
    rb = torch.minimum(b1[..., 2:4], b2[..., 2:4])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_sum = ((box1[..., 2] * box1[..., 3]).clamp_min(0.0)
                + (box2[..., 2] * box2[..., 3]).clamp_min(0.0))
    return inter / (area_sum - inter + eps)


def _iou_loss(pred_xywh, tar_xywh, iou_type, eps=EPS):
    """Regression loss: 1 - iou^2, 1 - giou or 1 - ciou."""
    iou = _iou_xywh(pred_xywh, tar_xywh, eps)
    if iou_type == "iou":
        return 1.0 - iou.square()
    b1, b2 = xywh2xyxy(pred_xywh), xywh2xyxy(tar_xywh)
    cw = (torch.maximum(b1[..., 2], b2[..., 2])
          - torch.minimum(b1[..., 0], b2[..., 0])).clamp_min(0.0)
    ch = (torch.maximum(b1[..., 3], b2[..., 3])
          - torch.minimum(b1[..., 1], b2[..., 1])).clamp_min(0.0)
    if iou_type == "giou":
        union = ((pred_xywh[..., 2] * pred_xywh[..., 3]).clamp_min(0.0)
                 + (tar_xywh[..., 2] * tar_xywh[..., 3]).clamp_min(0.0))
        convex = cw * ch
        giou = iou - (convex - union).abs() / (convex + eps)
        return 1.0 - giou.clamp(-1.0, 1.0)
    c_diag = cw.square() + ch.square() + eps
    dist = ((pred_xywh[..., 0] - tar_xywh[..., 0]).square()
            + (pred_xywh[..., 1] - tar_xywh[..., 1]).square())
    v = (4.0 / math.pi ** 2) * (
        torch.atan(pred_xywh[..., 2] / pred_xywh[..., 3].clamp_min(eps))
        - torch.atan(tar_xywh[..., 2] / tar_xywh[..., 3].clamp_min(eps))).square()
    alpha = (v / (1.0 - iou + v).clamp_min(eps)).detach()
    return 1.0 - (iou - dist / c_diag - v * alpha)


def _min4(a, b, c, d):
    return torch.minimum(torch.minimum(a, b), torch.minimum(c, d))


def _cls_cost(t_onehot, pred_decoded, cfg):
    """(c, M, 1) with the zeroed logits, else (c, M, P): BCE between
    sqrt(cls * cof) and the gt's one-hot row, summed over classes."""
    if not cfg.use_pred_cls_in_cost:
        half = t_onehot.new_full((), 0.5)
        joint = torch.sqrt((half * half).clamp(EPS, 1.0))
        terms = t_onehot * torch.log(joint) + (1.0 - t_onehot) * torch.log(
            (1.0 - joint).clamp_min(EPS))
        return -terms.sum(-1)[..., None]
    p_cof = torch.sigmoid(pred_decoded[..., 4])  # (c, P)
    p_cls = torch.sigmoid(pred_decoded[..., 5:])  # (c, P, nc)
    joint = torch.sqrt((p_cls * p_cof[..., None]).clamp(EPS, 1.0))
    log_j, log_1mj = torch.log(joint)[:, None], torch.log((1.0 - joint).clamp_min(EPS))[:, None]
    c, m, nc = t_onehot.shape
    step = max(1, CLS_COST_ELEMENTS // max(c * joint.shape[1] * nc, 1))
    parts = []
    for lo in range(0, m, step):
        t = t_onehot[:, lo:lo + step, None, :]
        parts.append(-(t * log_j + (1.0 - t) * log_1mj).sum(-1))
    return torch.cat(parts, dim=1)


def _rank_below(cost, k, kmax):
    """(c, M, P) bool: the columns of rank < ``k`` (c, M) in each row's
    stable ascending order, from the k-th smallest cost (k <= kmax)."""
    smallest = torch.topk(cost, kmax, dim=-1, largest=False, sorted=True).values
    kth = torch.take_along_dim(smallest, (k - 1)[..., None].long(), dim=-1)
    below = cost < kth
    tied = cost == kth
    need = k[..., None] - below.sum(-1, keepdim=True, dtype=torch.int32)
    return below | (tied & (torch.cumsum(tied, dim=-1, dtype=torch.int32) <= need))


def _simota_chunk(gt_xywh, gt_cls, gt_valid, pred_decoded, ctr_grid, cfg):
    """SimOTA over a chunk of images: gt_xywh (c, M, 4) input pixels, gt_cls
    (c, M) int64, gt_valid (c, M) bool, pred_decoded (c, P, 5+nc) pixel
    xywh and raw logits, ctr_grid (P, 2) cell centres in pixels."""
    c, m = gt_valid.shape
    p = ctr_grid.shape[0]
    cx, cy = ctr_grid[:, 0], ctr_grid[:, 1]
    gx, gy = gt_xywh[..., 0:1], gt_xywh[..., 1:2]  # (c, M, 1)
    half = gt_xywh[..., 2:4] * 0.5
    gt_min, gt_max = gt_xywh[..., 0:2] - half, gt_xywh[..., 0:2] + half
    valid = gt_valid[..., None]

    in_box = (_min4(cx - gt_min[..., 0:1], cy - gt_min[..., 1:2],
                    gt_max[..., 0:1] - cx, gt_max[..., 1:2] - cy) > EPS) & valid
    # no cell centre inside any box of the image: each gt's nearest cell
    dist2 = (gx - cx).square() + (gy - cy).square()
    nearest = (torch.arange(p, device=dist2.device) == dist2.argmin(-1, keepdim=True)) & valid
    in_box_all = torch.where(in_box.flatten(1).any(-1, keepdim=True), in_box.any(1),
                             nearest.any(1))  # (c, P)
    r = cfg.center_radius
    in_ctr = (_min4(cx - (gx - r), cy - (gy - r), (gx + r) - cx, (gy + r) - cy) > EPS) & valid
    in_ctr_all = in_ctr.any(1)
    in_ctr_all = torch.where(in_ctr_all.any(-1, keepdim=True), in_ctr_all, in_box_all)
    fg_cand = in_box_all | in_ctr_all
    pair_ok = in_box & in_ctr
    live = valid & fg_cand[:, None, :]  # (c, M, P)

    iou = _iou_xywh(gt_xywh[:, :, None, :], pred_decoded[:, None, :, 0:4])
    iou = torch.where(live, iou, 0.0)
    t_onehot = F.one_hot(gt_cls, cfg.num_class).float() * cfg.class_smooth_factor
    cost = (_cls_cost(t_onehot, pred_decoded, cfg) + 3.0 * -torch.log(iou + EPS)
            + (~pair_ok).float() * BIG)
    cost = torch.where(live, cost, math.inf)

    kmax = min(cfg.topk, p)
    dynamic_k = torch.topk(iou, kmax, dim=-1).values.sum(-1).int().clamp(1, p)
    finite = torch.isfinite(cost)
    matching = _rank_below(cost, dynamic_k, kmax) & valid & finite
    # a column picked by more than one gt goes to the gt of least cost over
    # all gts, even one that did not pick it
    winner = torch.where(finite, cost, 1e30).argmin(1)  # (c, P)
    winner_mat = (torch.arange(m, device=cost.device)[None, :, None] == winner[:, None, :]) & finite
    matching = torch.where(matching.sum(1, keepdim=True) > 1, winner_mat, matching)

    fg = matching.any(1)
    matched_gt = matching.to(torch.uint8).argmax(1)  # the first gt that matched
    matched_iou = torch.where(fg, torch.take_along_dim(iou, matched_gt[:, None], 1)[:, 0], 0.0)
    return fg, matched_gt, matched_iou


def simota_assign(gt_xywh, gt_cls, gt_valid, pred_decoded, ctr_grid, cfg: YOLOXLossConfig):
    """SimOTA of a batch at one stage, ``cfg.image_chunk`` images at a time.
    Returns fg (B, P) bool, the matched gt slot (B, P) int64 (0 where not
    fg) and its IoU (B, P)."""
    b = gt_valid.shape[0]
    step = max(1, min(cfg.image_chunk, b))
    outs = [_simota_chunk(gt_xywh[i:i + step], gt_cls[i:i + step], gt_valid[i:i + step],
                          pred_decoded[i:i + step], ctr_grid, cfg) for i in range(0, b, step)]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def yolox_loss(stage_preds: Sequence[torch.Tensor], targets: torch.Tensor,
               balances: torch.Tensor, cfg: YOLOXLossConfig):
    """The YOLOX training loss.

    stage_preds: per-stage NCHW maps (B, 5+nc, H, W) at strides 8/16/32;
    targets: (B, M, 6) [xmin, ymin, xmax, ymax, cls, img_idx] in input
    pixels, padding rows -1; balances: (stages,) conf balance state.
    Returns (loss_dict, new_balances); ``loss_dict['tot_loss']`` is the
    scalar to differentiate, the other entries are detached."""
    dev = stage_preds[0].device
    b = targets.shape[0]
    nc = cfg.num_class
    balances = balances.to(dev)
    gt_valid = targets[..., 4] >= 0
    half_wh = (targets[..., 2:4] - targets[..., 0:2]) * 0.5
    gt_xywh = torch.cat([targets[..., 0:2] + half_wh, half_wh * 2.0], dim=-1).float()
    gt_cls = targets[..., 4].to(torch.int64).clamp(0, nc - 1)
    t_onehot = F.one_hot(gt_cls, nc).float() * cfg.class_smooth_factor

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tot = {"iou_loss": zero, "cls_loss": zero, "cof_loss": zero, "l1_loss": zero,
           "fg_nums": zero}
    new_balances = []
    for si, pred in enumerate(stage_preds):
        _, c, h, w = pred.shape
        no = 5 + nc
        stride = cfg.input_size[0] / h
        pred = pred.float().view(b, c // no, no, h, w).permute(0, 3, 4, 1, 2).reshape(b, -1, no)
        ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                                torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
        grid = torch.stack([xs, ys], dim=-1).reshape(-1, 2)
        ctr_grid = (grid + 0.5) * stride

        dec_xy = (pred[..., 0:2] + grid) * stride
        dec_wh = torch.exp(pred[..., 2:4].clamp(-20.0, 20.0)) * stride
        decoded = torch.cat([dec_xy, dec_wh, pred[..., 4:]], dim=-1)

        with record_function("yolox_loss.assign"), torch.no_grad():
            fg, matched_gt, _ = simota_assign(gt_xywh, gt_cls, gt_valid, decoded, ctr_grid, cfg)
        # the targets at the matched gts; the class target's IoU is taken
        # again with its gradient, which reaches the boxes as in JAX
        tar_box = torch.take_along_dim(gt_xywh, matched_gt[..., None], 1)
        matched_iou = torch.where(fg, _iou_xywh(tar_box, decoded[..., 0:4]), 0.0)
        tar_cls = torch.take_along_dim(t_onehot, matched_gt[..., None], 1) * matched_iou[..., None]
        fgf = fg.float()
        num_fg = fgf.sum().clamp_min(1.0)

        iou_l = _iou_loss(decoded[..., 0:4], tar_box, cfg.iou_type)
        tot["iou_loss"] = tot["iou_loss"] + (iou_l * fgf).sum() / num_fg
        if cfg.use_l1:
            tar_l1 = torch.cat([tar_box[..., 0:2] / stride - grid,
                                torch.log(tar_box[..., 2:4] / stride + 1e-16)], dim=-1)
            l1 = (pred[..., 0:4] - tar_l1).abs().mean(-1)
            tot["l1_loss"] = tot["l1_loss"] + (l1 * fgf).sum() / num_fg

        cof_logits = pred[..., 4]
        bce_cof = bce_with_logits(cof_logits, fgf, cfg.cof_pos_weight)
        if cfg.use_focal_loss:
            bce_cof = bce_cof * focal_loss_factor(cof_logits, fgf, cfg.focal_loss_gamma,
                                                  cfg.focal_loss_alpha)
        cof_i = bce_cof.sum() / num_fg * balances[si]
        new_balances.append(balances[si] * 0.9999 + 0.0001 / cof_i.detach())
        tot["cof_loss"] = tot["cof_loss"] + cof_i

        cls_logits = pred[..., 5:]
        bce_cls = bce_with_logits(cls_logits, tar_cls, cfg.cls_pos_weight)
        if cfg.use_focal_loss:
            bce_cls = bce_cls * focal_loss_factor(cls_logits, tar_cls, cfg.focal_loss_gamma,
                                                  cfg.focal_loss_alpha)
        tot["cls_loss"] = tot["cls_loss"] + (bce_cls.mean(-1) * fgf).sum() / num_fg
        tot["fg_nums"] = tot["fg_nums"] + fgf.sum()

    new_balances = torch.stack(new_balances)
    new_balances = new_balances / new_balances[1]
    iou_loss = tot["iou_loss"] * cfg.iou_loss_scale
    cls_loss = tot["cls_loss"] * cfg.cls_loss_scale
    cof_loss = tot["cof_loss"] * cfg.cof_loss_scale
    l1_loss = tot["l1_loss"] * cfg.l1_loss_scale
    loss_dict = {
        "tot_loss": iou_loss + cls_loss + cof_loss + l1_loss,
        "iou_loss": iou_loss.detach(),
        "cls_loss": cls_loss.detach(),
        "cof_loss": cof_loss.detach(),
        "l1_loss": l1_loss.detach(),
        "fg_nums": tot["fg_nums"].detach(),
        "tar_nums": gt_valid.float().sum(),
    }
    return loss_dict, new_balances
