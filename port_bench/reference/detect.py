"""Plain PyTorch detection post-processing: dense decode, the candidate
gate, one stable sort, class-aware greedy NMS by its definition, and the
supporter-count merge.

Semantics (the serving path of ultralytics' ``non_max_suppression`` with
the JAX package's fixed shapes): score = sigmoid(obj) * max sigmoid(cls);
a candidate lives where obj >= conf and score > cls_thr; the K best live
candidates by score (equal scores: lower flat index first) go to NMS; each
class's boxes are shifted into their own block of coordinates (class x
4096), so boxes of two classes never overlap; greedy NMS keeps the best
live box and kills every box whose IoU with it is >= iou_thr, up to
``max_keep`` keepers; the merge drops a keeper that no other live candidate
overlaps by IoU > iou_thr, where 1 < live candidates < 3000.

The family's module (``families/<family>.py``) decodes the raw maps; the
flat index of a candidate is ((y * W + x) * A + a) per stage, A the
anchors a cell (1 where the family has none), stages concatenated in
stride order, as the JAX package numbers them.
"""

from __future__ import annotations

import torch

from .families import family

CLASS_OFFSET = 4096.0
MERGE_GATE_MAX = 3000


def stage_rows(m, na):
    """A raw map (B, na * C, H, W) as rows (B, H * W * na, C) in the flat
    order, with each row's anchor index (N,) and its cell's (x, y) (N, 2)."""
    b, c, h, w = m.shape
    rows = m.float().reshape(b, na, c // na, h, w).permute(0, 3, 4, 1, 2)
    rows = rows.reshape(b, h * w * na, c // na)
    flat = torch.arange(rows.shape[1], device=rows.device)
    cell = flat // na
    return rows, flat % na, torch.stack([(cell % w).float(), (cell // w).float()], -1)


def candidates(xy, wh, obj, cls_raw):
    """One stage's (boxes xyxy, obj, cls max prob, cls id) from box centres
    and sizes, objectness probabilities and class logits."""
    return (torch.cat([xy - wh / 2, xy + wh / 2], -1), obj, torch.sigmoid(cls_raw.amax(-1)),
            cls_raw.argmax(-1))


def concat(parts):
    """The stages' candidates, concatenated in stage order."""
    return tuple(torch.cat(p, 1) for p in zip(*parts))


def decode(maps, cfg):
    """Raw maps -> (boxes xyxy (B, N, 4), obj (B, N), cls max prob (B, N),
    cls id (B, N)) over every stage, by the configuration's family."""
    return family(cfg).decode(maps, cfg)


def pairwise_iou(a, b):
    """(B, N, 4) x (B, M, 4) -> (B, N, M)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter).clamp_min(1e-9)


def greedy_nms(boxes, scores, thr, max_keep):
    """The argmax loop: (keep_idx (B, max_keep) long, keep_valid bool)."""
    live = scores.clone()
    rows = torch.arange(live.shape[0], device=live.device)
    idxs, valids = [], []
    for _ in range(max_keep):
        idx = live.argmax(1)
        valid = live[rows, idx] > 0
        ious = pairwise_iou(boxes[rows, idx][:, None], boxes)[:, 0]
        live = torch.where(valid[:, None] & (ious >= thr), 0.0, live)
        live[rows, idx] = 0.0
        idxs.append(idx)
        valids.append(valid)
    return torch.stack(idxs, 1), torch.stack(valids, 1)


def detect(maps, cfg, t):
    """Raw maps -> (detections (B, max_keep, 6) [x1, y1, x2, y2, conf, cls]
    with conf 0 in unused slots, the IoUs exact greedy cannot avoid on these
    candidates, per image (B,))."""
    boxes, obj, cls_p, cls_id = decode(maps, cfg)
    score = obj * cls_p
    live = (obj >= t["conf_threshold"]) & (score > t["cls_threshold"])
    score = torch.where(live, score, 0.0)
    score_k, order = torch.sort(score, dim=1, descending=True, stable=True)
    k = min(t["num_candidates"], score.shape[1])
    score_k, order = score_k[:, :k], order[:, :k]
    boxes_k = torch.take_along_dim(boxes, order[..., None], 1)
    cls_k = torch.take_along_dim(cls_id, order, 1).float()
    boxes_off = boxes_k + cls_k[..., None] * CLASS_OFFSET
    thr, max_keep = t["iou_threshold"], t["max_keep"]
    keep, valid = greedy_nms(boxes_off, score_k, thr, max_keep)
    conf = torch.where(valid, torch.take_along_dim(score_k, keep, 1), 0.0)
    n_live = (score_k > 0).sum(1)
    if t.get("merge_boxes", True):
        kept = torch.take_along_dim(boxes_off, keep[..., None], 1)
        support = ((pairwise_iou(kept, boxes_off) > thr) & (score_k[:, None] > 0)).sum(-1)
        gated = (n_live > 1) & (n_live < MERGE_GATE_MAX)
        conf = torch.where(gated[:, None] & (support <= 1), 0.0, conf)
    dets = torch.cat([torch.take_along_dim(boxes_k, keep[..., None], 1), conf[..., None],
                      torch.take_along_dim(cls_k, keep, 1)[..., None]], -1)
    # greedy's IoUs on sorted candidates: each keeper against the keepers
    # before it, and one for each live candidate up to the max_keep-th
    # keeper that an earlier keeper kills
    n = valid.sum(1)
    seen = torch.where(valid.all(1), keep[:, -1] + 1, n_live)
    return dets, n * (n - 1) // 2 + seen - n
