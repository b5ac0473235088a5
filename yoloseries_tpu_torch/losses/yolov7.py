"""YOLOv7 loss: YOLOv5's anchor match, then an OTA refinement of its
candidates; the form of ``yoloseries_tpu/losses/yolov7.py``.

* Stage 1: the dense (B, M, A, 5) YOLOv5 lattice of ``losses/yolov5.py``
  (``_assign_stage_thr``) gives C = M*A*5 candidate slots per image.
* Stage 2, per image (``image_chunk`` images at once): the (M, C) cost
  3 * -log(iou + 1e-9) + the class BCE of logit(sqrt(cls * cof)) against
  the gt's one-hot row; dynamic k is the int32 truncation of the SUM of each
  gt's ``topk`` largest -log(iou) (the reference sums loss magnitudes, not
  IoUs: kept), clipped to [1, topk]; each gt takes its k cheapest live
  candidates (the stable argsort's ranks, as ``jnp.argsort``: equal costs
  lowest index first); a candidate that more than one gt took goes to the gt
  of least cost over all gts (``argmin``: the first on ties).
* The class cost is reduced over the class axis once per candidate:
  sum_j bce(x_j, t_j) = sum_j softplus(x_j) + softplus(-x_c) - softplus(x_c)
  for the one-hot t of class c, so no (M, C, nc) term exists; JAX's full sum
  gives the same values to float rounding.
* Losses over the kept candidates: label-smoothed class BCE (eps 0.1), CIoU
  against the matched gt in the candidate cell's units, and the confidence
  BCE over the whole grid, summed and divided by the kept count (not a
  mean), with the clamped IoU as the target at the last writer of each cell
  in the reference's (offset, anchor, box) write order
  (``losses/yolov5.py::objectness_winners``). The stage balances follow the
  same EMA as YOLOv5's.

Maps are NCHW (B, A*(5+nc), H, W) as YOLOv5's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.boxes import xywh2xyxy, xyxy2xywhn
from ..ops.iou import ciou, pairwise_iou
from .common import bce_with_logits, focal_loss_factor, softplus
from .yolov5 import _assign_stage_thr, _order_key, objectness_winners
from .yolox import _rank_below

__all__ = ["YOLOv7LossConfig", "ota_class_cost", "ota_refine", "yolov7_loss"]

EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class YOLOv7LossConfig:
    num_class: int
    input_size: tuple = (640, 640)
    strides: tuple = (8, 16, 32)
    anchor_match_thr: float = 4.0
    topk: int = 10
    iou_loss_scale: float = 0.05
    cls_loss_scale: float = 0.5
    cof_loss_scale: float = 1.0
    cls_pos_weight: float = 1.0
    cof_pos_weight: float = 1.0
    label_smoothing: float = 0.1
    use_iou_as_tar_cof: bool = True
    use_focal_loss: bool = False
    focal_loss_gamma: float = 1.5
    focal_loss_alpha: float = 0.25
    image_chunk: int = 8


def ota_class_cost(cand_cof, cand_cls, gt_cls):
    """(c, M, C) class cost: the BCE of logit(sqrt(cls * cof)) against each
    gt's one-hot row, summed over the classes as sum_j softplus(x_j) (once
    per candidate) + softplus(-x_c) - softplus(x_c) at the gt's class c.
    cand_cof (c, C), cand_cls (c, C, nc) logits, gt_cls (c, M) int64."""
    joint = torch.sqrt((torch.sigmoid(cand_cls) * torch.sigmoid(cand_cof)[..., None])
                       .clamp(EPS, 1 - EPS))
    logit = torch.log(joint / (1.0 - joint))  # (c, C, nc)
    neg_sum = softplus(logit).sum(-1)  # (c, C): every class's target 0
    own = torch.gather(logit, 2, gt_cls[:, None, :].expand(-1, logit.shape[1], -1))
    return neg_sum[:, None, :] + (softplus(-own) - softplus(own)).transpose(1, 2)


def _ota_chunk(cand_mask, cand_box, cand_cof, cand_cls, gt_xyxy, gt_cls, gt_valid, topk):
    """The OTA refinement of a chunk of c images: cand_mask (c, C) bool,
    cand_box (c, C, 4) pixels xyxy, cand_cof (c, C) and cand_cls (c, C, nc)
    logits, gt_xyxy (c, M, 4), gt_cls (c, M) int64, gt_valid (c, M) bool.
    Returns keep (c, C) bool and the matched gt (c, C) int64."""
    m, c_n = gt_xyxy.shape[1], cand_mask.shape[1]
    iou = pairwise_iou(gt_xyxy, cand_box)  # (c, M, C)
    pair_live = gt_valid[:, :, None] & cand_mask[:, None, :]
    iou = torch.where(pair_live, iou, 0.0)
    neg_iou_loss = -torch.log(iou + EPS)

    k = min(topk, c_n)
    top = torch.topk(torch.where(pair_live, neg_iou_loss, -torch.inf), k, dim=-1).values
    top = torch.where(torch.isfinite(top), top, 0.0)
    dynamic_k = top.sum(-1).to(torch.int32).clamp(1, k)  # (c, M)

    cls_cost = ota_class_cost(cand_cof, cand_cls, gt_cls)
    cost = torch.where(pair_live, 3.0 * neg_iou_loss + cls_cost, torch.inf)
    finite = torch.isfinite(cost)
    matching = _rank_below(cost, dynamic_k, k) & pair_live & finite
    # a candidate taken by more than one gt goes to the gt of least cost
    # over all gts, even one that did not take it
    winner = torch.where(finite, cost, 1e30).argmin(1)  # (c, C)
    winner_mat = (torch.arange(m, device=cost.device)[None, :, None] == winner[:, None, :]) & finite
    matching = torch.where(matching.sum(1, keepdim=True) > 1, winner_mat, matching)
    return matching.any(1), matching.to(torch.uint8).argmax(1)


def ota_refine(cand_mask, cand_box, cand_cof, cand_cls, gt_xyxy, gt_cls, gt_valid,
               cfg: YOLOv7LossConfig):
    """The OTA refinement of a batch, ``cfg.image_chunk`` images at a time
    (see ``_ota_chunk``). Returns keep (B, C) bool, matched gt (B, C)."""
    b = cand_mask.shape[0]
    step = max(1, min(cfg.image_chunk, b))
    outs = [_ota_chunk(cand_mask[i:i + step], cand_box[i:i + step], cand_cof[i:i + step],
                       cand_cls[i:i + step], gt_xyxy[i:i + step], gt_cls[i:i + step],
                       gt_valid[i:i + step], cfg.topk) for i in range(0, b, step)]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def yolov7_loss(stage_preds: Sequence[torch.Tensor], targets: torch.Tensor, anchors,
                balances: torch.Tensor, cfg: YOLOv7LossConfig):
    """stage_preds: NCHW maps (B, A*(5+nc), H, W); targets (B, M, 6) [x1, y1,
    x2, y2, cls, img] in input pixels, -1 padded; anchors (stages, A, 2)
    pixels. Returns (loss_dict, new_balances)."""
    num_stages = len(stage_preds)
    dev = stage_preds[0].device
    batch_size, num_boxes = targets.shape[0], targets.shape[1]
    nc = cfg.num_class
    anchors = torch.as_tensor(anchors, dtype=torch.float32).to(dev, non_blocking=True)
    na = anchors.shape[1]
    no = 5 + nc
    h_in, w_in = cfg.input_size
    balances = balances.to(dev)
    eps = cfg.label_smoothing
    pos_t, neg_t = 1.0 - 0.5 * eps, 0.5 * eps

    gt_valid = targets[..., 4] >= 0
    gt_xyxy = targets[..., 0:4].float()
    t_xywhn = xyxy2xywhn(gt_xyxy, (w_in, h_in))
    gt_cls = targets[..., 4].to(torch.int64).clamp(0, nc - 1)

    s = 3.0 / num_stages
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    iou_loss, cls_loss, cof_loss, tar_num = zero, zero, zero, zero
    new_balances = []
    order_key = _order_key(num_boxes, na, dev)
    bidx = torch.arange(batch_size, device=dev)[:, None, None]
    c_n = num_boxes * na * 5

    def obj_term(lg, t):
        b = bce_with_logits(lg, t, cfg.cof_pos_weight)
        if cfg.use_focal_loss:
            b = b * focal_loss_factor(lg, t, cfg.focal_loss_gamma, cfg.focal_loss_alpha)
        return b

    for i, pred in enumerate(stage_preds):
        fm_h, fm_w = pred.shape[2], pred.shape[3]
        stride = w_in / fm_w
        anchors_stage = (anchors[i] / stride).float()  # (A, 2)
        pred = pred.view(batch_size, na, no, fm_h, fm_w)
        scale = torch.tensor([fm_w, fm_h, fm_w, fm_h], dtype=torch.float32)
        scale = scale.to(dev, non_blocking=True)
        a = _assign_stage_thr(t_xywhn * scale, gt_valid, anchors_stage, fm_w, fm_h,
                              cfg.anchor_match_thr)

        # candidate rows at their cells: (B, M, 5, A, no) -> (B, M, A, 5, no)
        gy, gx = a["gy"].long(), a["gx"].long()
        cur = pred[bidx, :, :, gy, gx].permute(0, 1, 3, 2, 4).float()
        cell = torch.stack([gx, gy], dim=-1).float()[:, :, None]  # (B, M, 1, 5, 2)
        anc = anchors_stage[None, None, :, None, :]
        cur_flat = cur.reshape(batch_size, c_n, no)

        with record_function("yolov7_loss.assign"), torch.no_grad():
            pxy = (torch.sigmoid(cur[..., 0:2]) * 2.0 - 0.5 + cell) * stride
            pwh = (torch.sigmoid(cur[..., 2:4]) * 2.0) ** 2 * anc * stride
            cand_box = xywh2xyxy(torch.cat([pxy, pwh], dim=-1)).reshape(batch_size, c_n, 4)
            keep, matched = ota_refine(a["mask"].reshape(batch_size, c_n), cand_box,
                                       cur_flat[..., 4], cur_flat[..., 5:], gt_xyxy, gt_cls,
                                       gt_valid, cfg)
        keepf = keep.float()
        n_pos = keepf.sum()
        tar_num = tar_num + n_pos

        m_xyxy = torch.take_along_dim(gt_xyxy, matched[..., None], 1)  # (B, C, 4)
        m_xywhn = xyxy2xywhn(m_xyxy, (w_in, h_in)) * scale
        cell_flat = cell.expand(batch_size, num_boxes, na, 5, 2).reshape(batch_size, c_n, 2)
        t_box = torch.cat([m_xywhn[..., 0:2] - cell_flat, m_xywhn[..., 2:4]], dim=-1)

        if nc >= 1:
            m_cls = torch.take_along_dim(gt_cls, matched, 1)
            t_cls = F.one_hot(m_cls, nc).float() * (pos_t - neg_t) + neg_t
            bce = bce_with_logits(cur_flat[..., 5:], t_cls, cfg.cls_pos_weight)
            if cfg.use_focal_loss:
                bce = bce * focal_loss_factor(cur_flat[..., 5:], t_cls, cfg.focal_loss_gamma,
                                              cfg.focal_loss_alpha)
            cls_loss = cls_loss + (bce.mean(-1) * keepf).sum() / n_pos.clamp_min(1.0)

        pxy_s = torch.sigmoid(cur_flat[..., 0:2]) * 2.0 - 0.5
        anc_flat = anc.expand(batch_size, num_boxes, na, 5, 2).reshape(batch_size, c_n, 2)
        pwh_s = (torch.sigmoid(cur_flat[..., 2:4]) * 2.0) ** 2 * anc_flat
        iou_val = ciou(xywh2xyxy(torch.cat([pxy_s, pwh_s], dim=-1)), xywh2xyxy(t_box))
        iou_loss = iou_loss + ((1.0 - iou_val) * keepf).sum() / n_pos.clamp_min(1.0)

        # objectness: full-grid bce(logit, 0) plus the winners' correction
        if cfg.use_iou_as_tar_cof:
            cof_target = iou_val.detach().clamp_min(0.0) * keepf
        else:
            cof_target = keepf
        full_sum = obj_term(pred[:, :, 4].float(), 0.0).sum()
        cells = ((gy * fm_w + gx) * na)[:, :, None, :] + torch.arange(
            na, device=dev)[None, None, :, None]
        with record_function("yolov7_loss.winners"):
            winner = objectness_winners(cells.reshape(batch_size, c_n), keep, order_key,
                                        fm_h * fm_w * na)
        l_cand = cur_flat[..., 4]
        corr = torch.where(winner, obj_term(l_cand, cof_target) - obj_term(l_cand, 0.0), 0.0)
        # sum over the kept count, not a mean over the grid
        cof_i = (full_sum + corr.sum()) / n_pos.clamp_min(1.0) * balances[i]
        new_balances.append(balances[i] * 0.9999 + 0.0001 / cof_i.detach())
        cof_loss = cof_loss + cof_i

    new_balances = torch.stack(new_balances)
    new_balances = new_balances / new_balances[1]

    iou_loss = iou_loss * cfg.iou_loss_scale * s
    cof_loss = cof_loss * cfg.cof_loss_scale * s * (1.0 if num_stages == 3 else 1.4)
    cls_loss = cls_loss * cfg.cls_loss_scale * s
    tot_loss = (iou_loss + cof_loss + cls_loss) * batch_size
    loss_dict = {
        "tot_loss": tot_loss,
        "iou_loss": iou_loss.detach() * batch_size,
        "cof_loss": cof_loss.detach() * batch_size,
        "cls_loss": cls_loss.detach() * batch_size,
        "tar_nums": tar_num.detach(),
    }
    return loss_dict, new_balances
