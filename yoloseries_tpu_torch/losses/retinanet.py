"""RetinaNet loss: dense max-IoU anchor assignment, focal BCE and smooth-L1;
the form of ``yoloseries_tpu/losses/retinanet.py``.

* Each anchor takes its best-IoU gt (IoU eps 1e-8; the first gt on ties):
  positive at IoU >= 0.5, negative below 0.4, ignored between; an image
  with no gt has only negatives. The (A, M) IoUs are built
  ``image_chunk`` images at a time: ~77k anchors at 640 px against 300 gt
  slots is 92 MB an image.
* Classification: alpha/gamma focal BCE on the logits, the focal weight
  from ``sigmoid(logits)`` as in the JAX package (the reference's clamp of
  the raw logits is not kept), summed over the cared anchors and classes
  and divided by the image's positive count, then the batch mean.
* Regression: smooth-L1 (beta 1/9) on the (dx, dy, dw, dh) deltas over the
  scale factors, and an IoU loss in delta space whose CIoU aspect term has
  the reference's swapped names (atan(h/w)), per image over the positive
  count, then the batch mean.
* The experiment variant adds a BCE on the fifth regression channel,
  target 1 at positives and 0 at negatives.

No balance state: the family passes the balances through.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.boxes import xyxy2xywh
from ..utils.trace import span
from .common import bce_with_logits

__all__ = ["RetinaNetLossConfig", "anchor_gt_iou", "retinanet_assign", "retinanet_loss"]


@dataclasses.dataclass(frozen=True)
class RetinaNetLossConfig:
    num_class: int
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.4
    alpha: float = 0.25
    gamma: float = 2.0
    delta_scales: tuple = (0.1, 0.1, 0.2, 0.2)
    l1_loss_scale: float = 0.5
    iou_loss_scale: float = 0.5
    cls_loss_scale: float = 0.2
    iou_type: str = "ciou"
    with_objectness: bool = False  # the experiment variant
    cof_loss_scale: float = 1.0
    image_chunk: int = 4


def anchor_gt_iou(anchors, gt_boxes):
    """(A, 4) x (c, M, 4) -> (c, A, M) IoU, union + 1e-8."""
    area_a = (anchors[:, 2] - anchors[:, 0]) * (anchors[:, 3] - anchors[:, 1])
    area_g = (gt_boxes[..., 2] - gt_boxes[..., 0]) * (gt_boxes[..., 3] - gt_boxes[..., 1])
    lt = torch.maximum(anchors[None, :, None, 0:2], gt_boxes[:, None, :, 0:2])
    rb = torch.minimum(anchors[None, :, None, 2:4], gt_boxes[:, None, :, 2:4])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[None, :, None] + area_g[:, None, :] - inter + 1e-8
    return inter / union


def retinanet_assign(anchors, gt_boxes, gt_valid, image_chunk=4):
    """Each anchor's best IoU (B, A) and its gt (B, A) int64, the IoUs of
    ``image_chunk`` images at a time; padded gts count as IoU -1."""
    b = gt_boxes.shape[0]
    step = max(1, min(image_chunk, b))
    best, arg = [], []
    for i in range(0, b, step):
        iou = anchor_gt_iou(anchors, gt_boxes[i:i + step])
        iou = torch.where(gt_valid[i:i + step, None, :], iou, -1.0)
        v, j = iou.max(dim=-1)
        best.append(v)
        arg.append(j)
    return torch.cat(best), torch.cat(arg)


def _smooth_l1(pred, target, beta=1.0 / 9.0):
    diff = (pred - target).abs()
    return torch.where(diff <= beta, 0.5 * diff**2 / beta, diff - 0.5 * beta)


def _delta_iou_loss(pred, target, iou_type, eps=1e-8):
    """IoU losses with the boxes in delta (xywh) space."""
    p_min, p_max = pred[..., 0:2] - pred[..., 2:4] / 2, pred[..., 0:2] + pred[..., 2:4] / 2
    t_min, t_max = target[..., 0:2] - target[..., 2:4] / 2, target[..., 0:2] + target[..., 2:4] / 2
    i_min, i_max = torch.maximum(p_min, t_min), torch.minimum(p_max, t_max)
    # products of two written out: the backward of torch.prod counts the
    # zeros on the host, a sync in every update
    inside = (i_min < i_max).to(pred.dtype)
    mask = inside[..., 0] * inside[..., 1]
    area_p, area_t = pred[..., 2] * pred[..., 3], target[..., 2] * target[..., 3]
    inter = (i_max[..., 0] - i_min[..., 0]) * (i_max[..., 1] - i_min[..., 1]) * mask
    union = area_p + area_t - inter
    iou = inter / (union + eps)
    if iou_type == "iou":
        return 1.0 - iou**2
    cw = torch.maximum(p_max[..., 0], t_max[..., 0]) - torch.minimum(p_min[..., 0], t_min[..., 0])
    ch = torch.maximum(p_max[..., 1], t_max[..., 1]) - torch.minimum(p_min[..., 1], t_min[..., 1])
    if iou_type == "giou":
        convex = cw * ch
        giou = iou - (convex - union) / convex.clamp_min(eps)
        return 1.0 - giou.clamp(-1.0, 1.0)
    c_diag = cw**2 + ch**2 + eps
    dist = (pred[..., 0] - target[..., 0]) ** 2 + (pred[..., 1] - target[..., 1]) ** 2
    # the reference's swapped names: atan(h / w), denominators not clamped
    v = (4.0 / math.pi**2) * (torch.atan(target[..., 3] / target[..., 2])
                              - torch.atan(pred[..., 3] / pred[..., 2])) ** 2
    alpha = (v / (1.0 - iou + v + eps)).detach()
    return 1.0 - (iou - dist / c_diag - v * alpha)


def retinanet_loss(regression, classification, targets, anchors, cfg: RetinaNetLossConfig,
                   reduce=None):
    """regression (B, A, 4 | 5) deltas (5: with the experiment's objectness),
    classification (B, A, nc) logits, targets (B, M, 6) [x1, y1, x2, y2,
    cls, img] -1 padded, anchors (A, 4) xyxy. Returns the loss dict.

    ``reduce``: a sum over data-parallel ranks (``parallel/dist.py::
    all_reduce_sum``), for the global batch's loss (the JAX pjit step's).
    Its one global term is the batch: each term is a mean over the images
    of the image's sum over its own positive count, so a rank sums its
    images' terms and divides by the global batch. Each rank's loss dict is
    then its share of the global loss (``tar_nums`` its own count). The
    positive count stays per image and the assignment needs no
    reduction."""
    nc = cfg.num_class
    dev = regression.device
    n_img = targets.shape[0]
    if reduce is not None:
        n_img = reduce(torch.full((), float(n_img), device=dev))

    def batch_mean(per_image):
        return per_image.sum() / n_img

    anchors = torch.as_tensor(anchors, dtype=torch.float32).to(dev, non_blocking=True)
    anchor_xywh = xyxy2xywh(anchors)
    gt_valid = targets[..., 4] >= 0
    gt_boxes = targets[..., 0:4].float()
    gt_cls = targets[..., 4].to(torch.int64).clamp(0, nc - 1)

    with span("retinanet_loss.assign"), torch.no_grad():
        iou_max, iou_arg = retinanet_assign(anchors, gt_boxes, gt_valid, cfg.image_chunk)
    has_gt = gt_valid.any(-1)[:, None]
    positive = (iou_max >= cfg.pos_iou_thr) & has_gt
    negative = (iou_max < cfg.neg_iou_thr) | ~has_gt
    posf = positive.float()
    num_pos = posf.sum(-1).clamp_min(1.0)  # (B,)

    m_cls = torch.take_along_dim(gt_cls, iou_arg, 1)
    m_box = torch.take_along_dim(gt_boxes, iou_arg[..., None], 1)

    logits = classification.float()
    # the one-hot rows of the positives, built as a bool mask (B, A, nc)
    t_cls = ((torch.arange(nc, device=dev) == m_cls[..., None]) & positive[..., None]).float()
    prob = torch.sigmoid(logits)
    pos_t = t_cls > 0
    focal = torch.where(pos_t, 1.0 - prob, prob) ** cfg.gamma * torch.where(
        pos_t, cfg.alpha, 1.0 - cfg.alpha)
    care = (positive | negative).float()
    bce = bce_with_logits(logits, t_cls) * focal * care[..., None]
    cls_loss = batch_mean(bce.sum(dim=(1, 2)) / num_pos)

    gt_xywh = xyxy2xywh(m_box)
    gw, gh = gt_xywh[..., 2].clamp_min(1.0), gt_xywh[..., 3].clamp_min(1.0)
    aw, ah = anchor_xywh[None, :, 2], anchor_xywh[None, :, 3]
    scales = torch.tensor(cfg.delta_scales, dtype=torch.float32).to(dev, non_blocking=True)
    deltas = torch.stack([(gt_xywh[..., 0] - anchor_xywh[None, :, 0]) / aw,
                          (gt_xywh[..., 1] - anchor_xywh[None, :, 1]) / ah,
                          torch.log(gw / aw), torch.log(gh / ah)], dim=-1) / scales

    reg = regression.float()
    reg_box = reg[..., 0:4]
    l1 = _smooth_l1(reg_box, deltas).mean(-1)
    l1_loss = batch_mean((l1 * posf).sum(-1) / num_pos)
    if cfg.iou_loss_scale > 0:
        iou_l = _delta_iou_loss(reg_box, deltas, cfg.iou_type)
        iou_loss = batch_mean((iou_l * posf).sum(-1) / num_pos)
    else:
        iou_loss = torch.zeros((), device=dev)

    tot = (l1_loss * cfg.l1_loss_scale + iou_loss * cfg.iou_loss_scale
           + cls_loss * cfg.cls_loss_scale)
    loss_dict = {
        "l1_loss": l1_loss.detach() * cfg.l1_loss_scale,
        "iou_loss": iou_loss.detach() * cfg.iou_loss_scale,
        "cls_loss": cls_loss.detach() * cfg.cls_loss_scale,
        "tar_nums": posf.sum(),
    }
    if cfg.with_objectness:
        bce_cof = bce_with_logits(reg[..., 4], posf) * care
        cof_loss = batch_mean(bce_cof.sum(-1) / num_pos) * cfg.cof_loss_scale
        tot = tot + cof_loss
        loss_dict["cof_loss"] = cof_loss.detach()
    loss_dict["tot_loss"] = tot
    return loss_dict
