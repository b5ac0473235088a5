"""Class-aware NMS and detection postprocessing with fixed output shapes.

Counterpart of ``yoloseries_tpu/ops/nms.py``. Confidence gating and top-K
candidate selection give static (B, K) candidates; greedy NMS (one of the
CUDA kernels of ``kernels/`` on a CUDA tensor) or soft-NMS (``soft_nms``,
plain PyTorch on either device, as the JAX package runs it in a
``lax.scan`` outside any Pallas kernel) picks keepers; the supporter-count
merge drops keepers with fewer than two supporters; the output is
(B, max_keep, 6) [x1, y1, x2, y2, conf, cls] with conf 0 in unused slots.

Ties: ``jax.lax.top_k`` puts equal scores lowest index first, and most
candidate slots are exact-zero ties; ``torch.topk`` promises no order, so
``stable_topk`` is a stable descending sort, sliced.
"""

from __future__ import annotations

import torch

from ..kernels.nms_greedy import GREEDY_MAX_K, greedy_nms, nms_greedy
from ..kernels.nms_matrix import MATRIX_MAX_K, matrix_nms, matrix_nms_chunked
from .iou import pairwise_iou

__all__ = [
    "CLASS_OFFSET",
    "candidate_gate",
    "greedy_nms",
    "stable_topk",
    "select_topk_candidates",
    "postprocess_detections",
    "nms_candidates",
    "soft_nms",
]

# Class-aware NMS trick: shift each class's boxes into a disjoint coordinate
# block so cross-class pairs never overlap.
CLASS_OFFSET = 4096.0

# Dispatch between the kernels by shape. These thresholds were picked for the
# JAX package's TPU kernels and are placeholders here until the H100 times
# of both kernels across B and K say where the crossover lies.
MATRIX_MAX_BATCH = 16

def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last dim, equal values lowest index first (the order
    of ``jax.lax.top_k``). Returns (values, int64 indices)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def select_topk_candidates(boxes, scores, classes, k: int):
    """Keep the k highest-scoring candidates (static shape). Returns
    (boxes (k, 4), scores (k,), classes (k,)); padded slots have score 0."""
    k = min(k, scores.shape[-1])
    scores_top, idx = stable_topk(scores, k)
    return boxes[idx], scores_top, classes[idx]


def candidate_gate(obj, score, conf_threshold, cls_threshold, conf_gate="v5"):
    """The candidates a family's evaluator keeps: "v5" obj >= conf, then
    score = obj * cls_max > cls_thr; "v7" (YOLOv7's) score >= conf, then
    score >= cls_thr."""
    if conf_gate == "v7":
        return (score >= conf_threshold) & (score >= cls_threshold)
    if conf_gate != "v5":
        raise ValueError(f"conf_gate {conf_gate!r}: 'v5' or 'v7'")
    return (obj >= conf_threshold) & (score > cls_threshold)


def postprocess_detections(pred, conf_threshold, cls_threshold, iou_threshold,
                           num_candidates=2048, max_keep=300, class_aware=True,
                           merge_boxes=True, nms_mode="greedy", merge_write_boxes=False,
                           merge_gate_max=3000, conf_gate="v5"):
    """(N, 5+nc) or (B, N, 5+nc) decoded predictions [cx, cy, w, h, obj,
    cls...] (sigmoided, input pixels) -> (..., max_keep, 6).

    Single-label gate, ``conf_gate`` "v5": obj >= conf, then obj * cls_max >
    cls_thr; "v7" (YOLOv7's evaluator): obj * cls_max >= conf, then
    obj * cls_max >= cls_thr."""
    single = pred.dim() == 2
    if single:
        pred = pred[None]
    obj = pred[..., 4]
    cls_probs = pred[..., 5:] * obj[..., None]  # (B, N, nc)
    half = pred[..., 2:4] * 0.5
    boxes = torch.cat([pred[..., 0:2] - half, pred[..., 0:2] + half], dim=-1)

    cls_conf = cls_probs.amax(dim=-1)
    cls_id = cls_probs.argmax(dim=-1).float()  # first maximal class
    valid = candidate_gate(obj, cls_conf, conf_threshold, cls_threshold, conf_gate)
    score = torch.where(valid, cls_conf, 0.0)
    score_k, idx = stable_topk(score, min(num_candidates, score.shape[-1]))
    boxes_k = torch.take_along_dim(boxes, idx[..., None], dim=1)
    cls_k = torch.take_along_dim(cls_id, idx, dim=1)

    out = nms_candidates(
        boxes_k, score_k, cls_k, iou_threshold=iou_threshold, max_keep=max_keep,
        class_aware=class_aware, merge_boxes=merge_boxes, nms_mode=nms_mode,
        merge_write_boxes=merge_write_boxes, merge_gate_max=merge_gate_max,
    )
    return out[0] if single else out


def _greedy_keep(boxes_off, score_k, iou_threshold, max_keep):
    """Keeper indices through the kernel that fits the shape (its plain twin
    on a CPU tensor)."""
    b_n, k_n = score_k.shape
    boxes_off = boxes_off.contiguous()
    score_k = score_k.contiguous()
    if k_n <= MATRIX_MAX_K and b_n <= MATRIX_MAX_BATCH:
        # small batch: suppression-chain-depth rounds over a K x K relation
        return matrix_nms(boxes_off, score_k, iou_threshold, max_keep)
    if k_n > GREEDY_MAX_K:
        # beyond the greedy kernel's shared-memory planes: sorted strips
        # through the matrix kernel with carried keeper kills
        return matrix_nms_chunked(boxes_off, score_k, iou_threshold, max_keep)
    return nms_greedy(boxes_off, score_k, iou_threshold, max_keep)


def _iou_one_vs_all(ref, ref_area, boxes, areas):
    """IoU of one box per image (B, 4) against (B, K, 4), in the JAX
    package's ``_iou_one_vs_all`` order of operations."""
    lt = torch.maximum(ref[:, None, 0:2], boxes[..., 0:2])
    rb = torch.minimum(ref[:, None, 2:4], boxes[..., 2:4])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (ref_area[:, None] + areas - inter).clamp_min(1e-9)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             max_keep: int, mode: str = "linear", sigma: float = 0.5,
             score_threshold: float = 0.001):
    """Soft-NMS over (B, K, 4) boxes and (B, K) scores, every image at once,
    ``max_keep`` steps: take the leftmost best live score; if it is above
    ``score_threshold`` keep it, zero it, and decay the live scores of the
    boxes whose IoU with it exceeds ``iou_threshold`` by ``1 - iou``
    (``mode="linear"``) or ``exp(-iou^2 / sigma)`` (``"exp"``). Returns
    (keep_idx int32, -1 where not valid; keep_valid; keep_scores, the score
    at selection time)."""
    if mode not in ("linear", "exp"):
        raise ValueError(f"soft-NMS mode {mode!r}: 'linear' or 'exp'")
    boxes = boxes.float()
    live = scores.float().clone()
    rows = torch.arange(live.shape[0], device=live.device)
    areas = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    keep_idx, keep_valid, keep_scores = [], [], []
    for _ in range(max_keep):
        idx = live.argmax(dim=1)  # first maximal value: lowest index on ties
        best = live[rows, idx]
        valid = best > score_threshold
        ious = _iou_one_vs_all(boxes[rows, idx], areas[rows, idx], boxes, areas)
        if mode == "linear":
            decay = torch.where(ious > iou_threshold, 1.0 - ious, 1.0)
        else:
            decay = torch.where(ious > iou_threshold, torch.exp(-(ious * ious) / sigma), 1.0)
        live = live * torch.where(valid[:, None], decay, 1.0)
        live[rows, idx] = torch.where(valid, 0.0, live[rows, idx])
        keep_idx.append(torch.where(valid, idx.to(torch.int32), -1))
        keep_valid.append(valid)
        keep_scores.append(best)
    return (torch.stack(keep_idx, dim=1), torch.stack(keep_valid, dim=1),
            torch.stack(keep_scores, dim=1))


def nms_candidates(boxes_k, score_k, cls_k, iou_threshold, max_keep=300,
                   class_aware=True, merge_boxes=True, nms_mode="greedy",
                   merge_write_boxes=False, merge_gate_max=3000):
    """NMS + supporter-count merge over pre-selected candidates.

    boxes_k (B, K, 4) xyxy, score_k (B, K) (0 = dead slot, sorted or not),
    cls_k (B, K) float class ids. Greedy NMS runs in the CUDA kernels on a
    CUDA tensor and in their plain twins on a CPU tensor; ``nms_mode``
    "soft_linear" / "soft_exp" runs ``soft_nms``, whose decayed scores
    become the output confidences. The merge drops
    keepers with fewer than 2 supporters and, with ``merge_write_boxes``
    (the retinanet evaluator), writes the IoU-weighted merged box into the
    output rows; it runs only where 1 < live candidates < ``merge_gate_max``
    (3000; fcos passes 301). Returns (B, max_keep, 6); unused slots have
    conf 0."""
    if nms_mode not in ("greedy", "soft_linear", "soft_exp"):
        raise ValueError(f"unknown nms_mode {nms_mode}")
    boxes_k = boxes_k.float()
    score_k = score_k.float()
    # the offset is added here, never inside a kernel, so the kernels and
    # their twins see the same coordinates to the last bit
    offset = cls_k * CLASS_OFFSET if class_aware else torch.zeros_like(cls_k)
    boxes_off = boxes_k + offset[..., None]

    if nms_mode == "greedy":
        keep_idx, keep_valid = _greedy_keep(boxes_off, score_k, iou_threshold, max_keep)
        safe_idx = keep_idx.clamp_min(0).long()  # (B, max_keep)
        keep_scores = torch.take_along_dim(score_k, safe_idx, dim=1)
    else:
        mode = "linear" if nms_mode == "soft_linear" else "exp"
        keep_idx, keep_valid, keep_scores = soft_nms(boxes_off, score_k, iou_threshold,
                                                     max_keep, mode=mode)
        safe_idx = keep_idx.clamp_min(0).long()
    out_boxes = torch.take_along_dim(boxes_k, safe_idx[..., None], dim=1)
    out_scores = torch.where(keep_valid, keep_scores, 0.0)
    out_cls = torch.take_along_dim(cls_k, safe_idx, dim=1)

    if merge_boxes:
        # the reference's supporter-count refinement: drop keepers with
        # fewer than 2 supporters (IoU > thr among live candidates), applied
        # only when 1 < live candidate count < merge_gate_max
        kept_off = torch.take_along_dim(boxes_off, safe_idx[..., None], dim=1)
        iou_km = pairwise_iou(kept_off, boxes_off)  # (B, max_keep, K)
        support = (iou_km > iou_threshold) & (score_k[:, None, :] > 0.0)
        n_support = support.sum(dim=-1)
        n_valid = (score_k > 0.0).sum(dim=-1)  # (B,)
        gated = (n_valid > 1) & (n_valid < merge_gate_max)
        if merge_write_boxes:
            w = torch.where(iou_km > iou_threshold, score_k[:, None, :], 0.0)
            merged = torch.matmul(w, boxes_k) / (w.sum(dim=-1, keepdim=True) + 1e-16)
            write = gated[:, None, None] & keep_valid[..., None]
            out_boxes = torch.where(write, merged, out_boxes)
        out_scores = torch.where(gated[:, None] & (n_support <= 1), 0.0, out_scores)

    return torch.cat([out_boxes, out_scores[..., None], out_cls[..., None]], dim=-1)
