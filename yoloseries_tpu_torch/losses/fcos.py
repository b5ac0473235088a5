"""FCOS loss: per-level range assignment with center sampling, centerness,
focal BCE; the form of ``yoloseries_tpu/losses/fcos.py``.

* Locations: cell centres ``idx * stride + stride // 2`` at the level's
  stride of ``cfg.strides`` (8, 16, ..., 128), on the map's own cells. The
  JAX package takes the stride as input height / map height, which is the
  same at inputs that are multiples of 128 (640 included) and not at
  others, where P7 is a ceil(H / 128) map.
* A location is positive for a gt when it lies inside the box (and, with
  center sampling, inside the box of ``radius * stride`` around its centre
  clipped to the gt) and max(ltrb) is within the level's regression range
  [[-1, 64], [64, 128], [128, 256], [256, 512], [512, inf]]; of several, the
  gt of least area wins (the first slot on ties). The (P, M) lattice is
  built ``image_chunk`` images at a time.
* Targets: ltrb / stride, centerness sqrt(min/max_lr * min/max_tb).
* Losses per image: the IoU loss (giou by default) summed over the positives
  and divided by their count (the reference's centerness weighting cancels
  itself: a (m, 1) loss broadcast against an (m,) weight); the centerness
  focal BCE over the positives over their count, or the plain BCE mean over
  all cells where an image has none; the label-smoothed focal class BCE,
  class-mean summed over all cells over the positive count; then the
  batch mean per level, the level mean, the weights, times the batch.

No balance state: the family passes the balances through.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch.profiler import record_function

from .common import bce_with_logits, focal_loss_factor

__all__ = ["FCOSLossConfig", "fcos_assign", "fcos_loss", "regression_ranges"]

INF = 1e8


@dataclasses.dataclass(frozen=True)
class FCOSLossConfig:
    num_class: int
    input_size: tuple = (640, 640)
    strides: tuple = (8, 16, 32, 64, 128)
    center_sampling_radius: float = 1.5
    do_center_sampling: bool = True
    iou_type: str = "giou"  # 'iou' | 'linear_iou' | 'giou'
    cls_loss_weight: float = 1.0
    reg_loss_weight: float = 1.0
    ctr_loss_weight: float = 1.0
    cls_pos_weight: float = 1.0
    ctr_pos_weight: float = 1.0
    class_smooth_factor: float = 0.0
    eps: float = 1e-6
    focal_loss_gamma: float = 1.5
    focal_loss_alpha: float = 0.25
    image_chunk: int = 8


def regression_ranges(num_levels: int, strides):
    """[[-1, 64], [64, 128], ..., [last / 2, INF]]."""
    out = []
    for i, s in enumerate(strides[:num_levels]):
        t = math.log2(s) + 3
        if i == 0:
            out.append((-1.0, 2.0**t))
        elif i == num_levels - 1:
            out.append((2.0 ** (t - 1), INF))
        else:
            out.append((2.0 ** (t - 1), 2.0**t))
    return out


def _iou_loss_ltrb(pred, tar, iou_type, eps):
    """(..., 4) [l, t, r, b] IoU losses."""
    pl, pt, pr, pb = pred.unbind(-1)
    tl, tt, tr, tb = tar.unbind(-1)
    tar_area = (tl + tr) * (tt + tb)
    pred_area = (pl + pr) * (pt + pb)
    w_inter = (torch.minimum(pl, tl) + torch.minimum(pr, tr)).clamp_min(0.0)
    h_inter = (torch.minimum(pb, tb) + torch.minimum(pt, tt)).clamp_min(0.0)
    gw = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    gh = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    ac = (gw * gh).clamp_min(eps)
    inter = w_inter * h_inter
    union = (tar_area + pred_area.clamp_min(0.0) - inter).clamp_min(eps)
    iou = inter / union
    if iou_type == "iou":
        return -torch.log(iou.clamp_min(eps))
    if iou_type == "linear_iou":
        return 1.0 - iou
    return 1.0 - (iou - (ac - union) / ac)


def _assign_chunk(grid_px, tar_xyxy, tar_valid, stride, rng_lo, rng_hi, cfg):
    """One level for a chunk of c images: grid_px (P, 2); tar_xyxy (c, M, 4),
    tar_valid (c, M). Returns pos (c, P), matched gt (c, P), the ltrb
    targets (c, P, 4) / stride and the centerness targets (c, P)."""
    gx, gy = grid_px[None, :, None, 0], grid_px[None, :, None, 1]
    x1, y1 = tar_xyxy[:, None, :, 0], tar_xyxy[:, None, :, 1]
    x2, y2 = tar_xyxy[:, None, :, 2], tar_xyxy[:, None, :, 3]
    ltrb = torch.stack([gx - x1, gy - y1, x2 - gx, y2 - gy], dim=-1)  # (c, P, M, 4)
    valid = tar_valid[:, None, :]
    in_box = (ltrb > 0.0).all(-1) & valid
    if cfg.do_center_sampling:
        cx, cy = (x1 + x2) * 0.5, (y1 + y2) * 0.5
        rad = cfg.center_sampling_radius * stride
        in_ctr = ((gx - torch.maximum(cx - rad, x1) > 0) & (gy - torch.maximum(cy - rad, y1) > 0)
                  & (torch.minimum(cx + rad, x2) - gx > 0)
                  & (torch.minimum(cy + rad, y2) - gy > 0)) & valid
        in_box = in_box & in_ctr
    max_ltrb = ltrb.amax(-1)
    cared = (max_ltrb >= rng_lo) & (max_ltrb <= rng_hi)

    area = (tar_xyxy[..., 2] - tar_xyxy[..., 0]) * (tar_xyxy[..., 3] - tar_xyxy[..., 1])
    area = torch.where(tar_valid, area, INF)
    area_pm = torch.where(in_box & cared, area[:, None, :], INF)  # (c, P, M)
    least, matched = area_pm.min(-1)
    pos = least < INF

    reg_tar = torch.take_along_dim(ltrb, matched[..., None, None], 2)[:, :, 0] / stride
    lr_min = torch.minimum(reg_tar[..., 0], reg_tar[..., 2])
    lr_max = torch.maximum(reg_tar[..., 0], reg_tar[..., 2])
    tb_min = torch.minimum(reg_tar[..., 1], reg_tar[..., 3])
    tb_max = torch.maximum(reg_tar[..., 1], reg_tar[..., 3])
    ctr_tar = torch.sqrt((lr_min / lr_max.clamp_min(cfg.eps)).clamp_min(0.0)
                         * (tb_min / tb_max.clamp_min(cfg.eps)).clamp_min(0.0))
    return pos, matched, reg_tar, ctr_tar


def fcos_assign(grid_px, tar_xyxy, tar_valid, stride, rng_lo, rng_hi, cfg: FCOSLossConfig):
    """``_assign_chunk`` over the batch, ``cfg.image_chunk`` images at a time."""
    b = tar_xyxy.shape[0]
    step = max(1, min(cfg.image_chunk, b))
    outs = [_assign_chunk(grid_px, tar_xyxy[i:i + step], tar_valid[i:i + step], stride, rng_lo,
                          rng_hi, cfg) for i in range(0, b, step)]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def level_grid(h: int, w: int, stride: float, device) -> torch.Tensor:
    """(h*w, 2) pixel centres of a level, row-major: idx * stride + stride // 2."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], -1).reshape(-1, 2).float() * stride + stride // 2


def fcos_loss(cls_fms: Sequence[torch.Tensor], reg_fms: Sequence[torch.Tensor],
              ctr_fms: Sequence[torch.Tensor], targets: torch.Tensor, cfg: FCOSLossConfig):
    """Per-level NCHW maps (B, nc | 4 | 1, H, W); targets (B, M, 6). Returns
    the loss dict."""
    b = targets.shape[0]
    nc = cfg.num_class
    dev = cls_fms[0].device
    num_levels = len(cls_fms)
    eps = cfg.class_smooth_factor
    pos_t, neg_t = 1.0 - 0.5 * eps, 0.5 * eps
    ranges = regression_ranges(num_levels, cfg.strides)
    tar_xyxy = targets[..., 0:4].float()
    tar_valid = targets[..., 4] >= 0
    tar_cls = targets[..., 4].to(torch.int64).clamp(0, nc - 1)

    stage_cls, stage_reg, stage_ctr = [], [], []
    tar_num = torch.zeros((), device=dev)
    for li in range(num_levels):
        h, w = cls_fms[li].shape[2:]
        stride = float(cfg.strides[li])
        p = h * w
        cls_l = cls_fms[li].float().permute(0, 2, 3, 1).reshape(b, p, nc)
        reg_l = reg_fms[li].float().permute(0, 2, 3, 1).reshape(b, p, 4)
        ctr_l = ctr_fms[li].float().reshape(b, p)
        with record_function("fcos_loss.assign"), torch.no_grad():
            pos, matched, reg_tar, ctr_tar = fcos_assign(level_grid(h, w, stride, dev), tar_xyxy,
                                                         tar_valid, stride, *ranges[li], cfg)
        posf = pos.float()
        n_pos = posf.sum(-1)
        tar_num = tar_num + posf.sum()

        t_ctr = ctr_tar * posf
        bce_ctr_raw = bce_with_logits(ctr_l, t_ctr, cfg.ctr_pos_weight)
        bce_ctr = bce_ctr_raw * focal_loss_factor(ctr_l, t_ctr, cfg.focal_loss_gamma,
                                                  cfg.focal_loss_alpha)
        # an image without positives: the plain BCE mean over all cells
        ctr_pos = (bce_ctr * posf).sum(-1) / n_pos.clamp_min(1.0)
        stage_ctr.append(torch.where(n_pos > 0, ctr_pos, bce_ctr_raw.mean(-1)).mean())

        iou_l = _iou_loss_ltrb(reg_l, reg_tar, cfg.iou_type, cfg.eps)
        reg_img = (iou_l * posf).sum(-1) / n_pos.clamp_min(1.0)
        stage_reg.append(torch.where(n_pos > 0, reg_img, 0.0).mean())

        m_cls = torch.take_along_dim(tar_cls, matched, 1)
        onehot = (torch.arange(nc, device=dev) == m_cls[..., None]) & pos[..., None]
        t_cls = onehot.float() * (pos_t - neg_t) + neg_t
        bce_cls = bce_with_logits(cls_l, t_cls, cfg.cls_pos_weight) * focal_loss_factor(
            cls_l, t_cls, cfg.focal_loss_gamma, cfg.focal_loss_alpha)
        stage_cls.append((bce_cls.mean(-1).sum(-1) / n_pos.clamp_min(1.0)).mean())

    cls_loss = torch.stack(stage_cls).mean() * cfg.cls_loss_weight
    reg_loss = torch.stack(stage_reg).mean() * cfg.reg_loss_weight
    ctr_loss = torch.stack(stage_ctr).mean() * cfg.ctr_loss_weight
    return {
        "tot_loss": (cls_loss + reg_loss + ctr_loss) * b,
        "cls_loss": cls_loss.detach() * b,
        "reg_loss": reg_loss.detach() * b,
        "cen_loss": ctr_loss.detach() * b,
        "tar_nums": tar_num.detach(),
    }
