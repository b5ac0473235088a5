"""YOLOv5 loss: the dense fixed-shape form of ``yoloseries_tpu/losses/yolov5.py``.

The assigner is a dense (B, M, A, 5) candidate lattice with a validity mask:
M target slots (-1 padded), A anchors per stage (ratio-filtered), and the 5
grid-expansion offsets {center, left, up, right, down}. Every term is a
masked mean. The stage balances [4, 1, 0.4] self-tune by an EMA on the
stage's conf loss, carried as a (3,) tensor through the train step.

Layout: the port's maps are NCHW (B, A*(5+nc), H, W), viewed as
(B, A, 5+nc, H, W). Candidate rows are gathered at their (gy, gx) cells,
which reads the same rows as the JAX package's flat gather at index
((gy*W + gx)*A + a) without copying the whole map into the NHWC order.

Objectness: the reference writes the clamped IoU of each candidate into a
dense target grid, duplicate cells last-write-wins in (offset o, anchor a,
box slot m) order. The loss is summed as bce(logit, 0) over the grid plus a
correction at the winners. The winner of a cell is found by sorting each
image's live candidates by (flat cell, order key) and taking the last of
each run of equal cells: O(J log J) for J = M*A*5 candidates, the same
winners as the (B, J, J) comparison of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.boxes import xywh2xyxy, xyxy2xywhn
from ..ops.iou import ciou
from .common import bce_with_logits, focal_loss_factor

__all__ = ["YOLOv5LossConfig", "yolov5_loss", "initial_balances", "objectness_winners"]

# grid-expansion offsets, in the reference's order
_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))


@dataclasses.dataclass(frozen=True)
class YOLOv5LossConfig:
    num_class: int
    input_size: tuple = (640, 640)  # (h, w)
    strides: tuple = (8, 16, 32)
    anchor_match_thr: float = 4.0
    iou_loss_scale: float = 0.05
    cls_loss_scale: float = 0.5
    cof_loss_scale: float = 1.0
    cls_pos_weight: float = 1.0
    cof_pos_weight: float = 1.0
    class_smooth_factor: float = 1.0
    use_focal_loss: bool = True
    focal_loss_gamma: float = 1.5
    focal_loss_alpha: float = 0.25


def initial_balances(num_stages: int = 3, device=None) -> torch.Tensor:
    """Per-stage conf-loss balances."""
    vals = [4.0, 1.0, 0.4] if num_stages == 3 else [4.0, 1.0, 0.4, 0.1]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def _order_key(num_boxes: int, na: int, device) -> torch.Tensor:
    """(J,) the reference's write order of each lattice slot. The lattice
    flattens (m, a, o) with o fastest; the reference writes (o, a, m) with o
    slowest, so the lex-max (o, a, m) is written last. A permutation of
    0..J-1."""
    j = torch.arange(num_boxes * na * 5, device=device)
    o, a, m = j % 5, (j // 5) % na, j // (5 * na)
    return (o * na + a) * num_boxes + m


def objectness_winners(cells: torch.Tensor, live: torch.Tensor, order_key: torch.Tensor,
                       n_cells: int):
    """(B, J) bool: live candidates that no other live candidate of the same
    image and cell follows in write order.

    cells (B, J) int64 flat cells in [0, n_cells); live (B, J) bool;
    order_key (J,) a permutation of 0..J-1. Dead candidates go to cell
    ``n_cells``, past the grid, so one sort of the unique keys
    ``cell * J + order_key`` puts each cell's candidates together in write
    order, and the winner is the last of its run."""
    j = cells.shape[1]
    key = torch.where(live, cells, n_cells) * j + order_key[None, :]
    sorted_key, perm = torch.sort(key, dim=1)
    cell_sorted = sorted_key // j
    last = torch.ones_like(live)
    last[:, :-1] = cell_sorted[:, 1:] != cell_sorted[:, :-1]
    winner = torch.zeros_like(live)
    winner.scatter_(1, perm, last)
    return winner & live


def yolov5_loss(stage_preds: Sequence[torch.Tensor], targets: torch.Tensor,
                anchors, balances: torch.Tensor, cfg: YOLOv5LossConfig, reduce=None):
    """The YOLOv5 training loss.

    stage_preds: per-stage NCHW maps (B, A*(5+nc), H, W) at strides 8/16/32;
    targets: (B, M, 6) [xmin, ymin, xmax, ymax, cls, img_idx] in input
    pixels, padding rows -1; anchors: (stages, A, 2) anchor wh in input
    pixels; balances: (stages,) conf-loss balance state.

    Returns (loss_dict, new_balances); ``loss_dict['tot_loss']`` is the
    scalar to differentiate, the other entries are detached.

    ``reduce``: a sum over data-parallel ranks (``parallel/dist.py::
    all_reduce_sum``), for the loss of the global batch that the JAX
    package's pjit step computes. The counts it divides by (the batch, the
    positives) and the stage losses that update the balances are summed
    over the ranks; each rank's ``loss_dict`` is then its share of the
    global loss, so that the shares (and their gradients) sum to it. The
    balances come out global, the same on every rank.
    """
    num_stages = len(stage_preds)
    dev = stage_preds[0].device
    batch_size, num_boxes = targets.shape[0], targets.shape[1]
    nc = cfg.num_class
    # constants reach the card with non_blocking copies: a blocking copy
    # would make the host wait for the forward pass here
    anchors = torch.as_tensor(anchors, dtype=torch.float32).to(dev, non_blocking=True)
    na = anchors.shape[1]
    no = 5 + nc
    h_in, w_in = cfg.input_size
    balances = balances.to(dev)
    if reduce is None:
        global_batch = batch_size
    else:
        global_batch = reduce(torch.full((), float(batch_size), device=dev))

    valid = targets[..., 4] >= 0  # (B, M)
    t_xywhn = xyxy2xywhn(targets[..., :4], (w_in, h_in))
    t_cls = targets[..., 4].to(torch.int64).clamp(0, nc - 1)  # padding -> 0, masked off

    thr = cfg.anchor_match_thr
    s = 3.0 / num_stages
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    iou_loss, cls_loss, cof_loss, tar_num = zero, zero, zero, zero
    new_balances = []
    order_key = _order_key(num_boxes, na, dev)
    bidx = torch.arange(batch_size, device=dev)[:, None, None]

    for i, pred in enumerate(stage_preds):
        fm_h, fm_w = pred.shape[2], pred.shape[3]
        stride = w_in / fm_w
        anchors_stage = (anchors[i] / stride).float()  # (A, 2)
        pred = pred.view(batch_size, na, no, fm_h, fm_w)

        scale = torch.tensor([fm_w, fm_h, fm_w, fm_h], dtype=torch.float32)
        scale = scale.to(dev, non_blocking=True)
        t_stage = t_xywhn.float() * scale  # (B, M, 4)

        a = _assign_stage_thr(t_stage, valid, anchors_stage, fm_w, fm_h, thr)
        maskf = a["mask"].float()  # (B, M, A, 5)
        n_pos = maskf.sum()
        tar_num = tar_num + n_pos
        if reduce is not None:
            n_pos = reduce(n_pos.clone())

        # rows at the assigned cells: (B, M, 5, A, no) -> (B, M, A, 5, no)
        gy, gx = a["gy"].long(), a["gx"].long()
        cur = pred[bidx, :, :, gy, gx].permute(0, 1, 3, 2, 4).float()

        if nc > 1:
            cls_logits = cur[..., 5:]
            t_onehot = (F.one_hot(t_cls, nc).float()[:, :, None, None, :]
                        * cfg.class_smooth_factor).expand_as(cls_logits)
            bce = bce_with_logits(cls_logits, t_onehot, cfg.cls_pos_weight)
            if cfg.use_focal_loss:
                bce = bce * focal_loss_factor(cls_logits, t_onehot, cfg.focal_loss_gamma,
                                              cfg.focal_loss_alpha)
            cls_loss = cls_loss + (bce * maskf[..., None]).sum() / torch.clamp_min(n_pos * nc, 1.0)

        pxy = torch.sigmoid(cur[..., 0:2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(cur[..., 2:4]) * 2.0) ** 2 * anchors_stage[None, None, :, None, :]
        pred_box = xywh2xyxy(torch.cat([pxy, pwh], dim=-1))
        t_box = xywh2xyxy(torch.cat([
            a["t_off"][:, :, None, :, :].expand(batch_size, num_boxes, na, 5, 2),
            a["t_wh"][:, :, None, None, :].expand(batch_size, num_boxes, na, 5, 2),
        ], dim=-1))
        iou_val = ciou(pred_box, t_box)  # (B, M, A, 5)
        iou_loss = iou_loss + ((1.0 - iou_val) * maskf).sum() / torch.clamp_min(n_pos, 1.0)

        # objectness: full-grid bce(logit, 0) plus the winners' correction
        iou_detached = iou_val.detach().clamp_min(0.0) * maskf

        def obj_term(lg, t):
            b = bce_with_logits(lg, t, cfg.cof_pos_weight)
            if cfg.use_focal_loss:
                b = b * focal_loss_factor(lg, t, cfg.focal_loss_gamma, cfg.focal_loss_alpha)
            return b

        full_sum = obj_term(pred[:, :, 4].float(), 0.0).sum()
        vals = iou_detached.reshape(batch_size, -1)  # (B, J)
        # flat cell ((gy*W + gx)*A + a) of each lattice slot, as in the JAX package
        flat_cell = (gy * fm_w + gx) * na  # (B, M, 5)
        cells = (flat_cell[:, :, None, :]
                 + torch.arange(na, device=dev)[None, None, :, None]).reshape(batch_size, -1)
        with record_function("yolov5_loss.winners"):
            winner = objectness_winners(cells, maskf.reshape(batch_size, -1) > 0, order_key,
                                        fm_h * fm_w * na)
        l_cand = cur[..., 4].reshape(batch_size, -1)
        corr = torch.where(winner, obj_term(l_cand, vals) - obj_term(l_cand, 0.0), 0.0)
        cof_i = (full_sum + corr.sum()) / (global_batch * (fm_h * fm_w * na)) * balances[i]
        cof_global = cof_i.detach() if reduce is None else reduce(cof_i.detach().clone())
        new_balances.append(balances[i] * 0.9999 + 0.0001 / cof_global)
        cof_loss = cof_loss + cof_i

    new_balances = torch.stack(new_balances)
    new_balances = new_balances / new_balances[1]

    iou_loss = iou_loss * cfg.iou_loss_scale * s
    cof_loss = cof_loss * cfg.cof_loss_scale * s * (1.0 if num_stages == 3 else 1.4)
    cls_loss = cls_loss * cfg.cls_loss_scale * s
    tot_loss = (iou_loss + cof_loss + cls_loss) * global_batch

    loss_dict = {
        "tot_loss": tot_loss,
        "iou_loss": iou_loss.detach() * global_batch,
        "cof_loss": cof_loss.detach() * global_batch,
        "cls_loss": cls_loss.detach() * global_batch,
        "tar_nums": tar_num.detach(),
    }
    return loss_dict, new_balances


def _assign_stage_thr(t_stage, valid, anchors_stage, fm_w, fm_h, thr):
    """Dense positive-candidate lattice of one stage.

    t_stage (B, M, 4) targets in feature-map units (cx, cy, w, h); valid
    (B, M) bool; anchors_stage (A, 2) in feature-map units. Returns mask
    (B, M, A, 5) bool, gx/gy (B, M, 5) int32 cells (clamped), t_off
    (B, M, 5, 2) xy offsets from the cell, t_wh (B, M, 2)."""
    t_wh = t_stage[..., 2:4]
    gxy = t_stage[..., 0:2]

    ratio = t_wh[:, :, None, :] / anchors_stage[None, None, :, :] + 1e-16
    ar_ok = torch.maximum(ratio, 1.0 / ratio).amax(dim=-1) < thr

    # `%` is floor modulo here, as in numpy and JAX (torch.fmod would not be)
    dev = t_stage.device
    gxy_inv = torch.tensor([fm_w, fm_h], dtype=t_stage.dtype).to(dev, non_blocking=True) - gxy
    near_lo = (torch.remainder(gxy, 1.0) < 0.5) & (gxy > 1.0)
    near_hi = (torch.remainder(gxy_inv, 1.0) < 0.5) & (gxy_inv > 1.0)
    grid_masks = torch.stack([torch.ones_like(near_lo[..., 0]), near_lo[..., 0], near_lo[..., 1],
                              near_hi[..., 0], near_hi[..., 1]], dim=-1)

    mask = valid[:, :, None, None] & ar_ok[:, :, :, None] & grid_masks[:, :, None, :]

    offs = torch.tensor(_OFFSETS, dtype=t_stage.dtype).to(dev, non_blocking=True)
    cell = torch.floor(gxy[:, :, None, :] - offs[None, None, :, :])
    t_off = gxy[:, :, None, :] - cell
    gx = cell[..., 0].to(torch.int32).clamp(0, fm_w - 1)
    gy = cell[..., 1].to(torch.int32).clamp(0, fm_h - 1)
    return {"mask": mask, "gx": gx, "gy": gy, "t_off": t_off, "t_wh": t_wh}
