"""Weighted Boxes Fusion on the host (numpy).

Counterpart of ``yoloseries_tpu/ops/wbf.py``: per class, boxes are taken in
descending score order and each joins every fused box it overlaps with IoU
>= ``iou_thr`` (or starts a new cluster); a cluster fuses into the
score-weighted mean box with the model-weight-weighted mean score. The
alternative to NMS when merging TTA branches (``Evaluator.detect_wbf``).
The clustering is sequential per image and runs on the host, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np

from .metrics import pairwise_iou_np

__all__ = ["weighted_boxes_fusion"]


def _fuse_cluster(cluster: np.ndarray) -> np.ndarray:
    """cluster (N, 7) [x1, y1, x2, y2, score, cls, weight] -> fused (6,)."""
    boxes, scores, weights = cluster[:, :4], cluster[:, 4], cluster[:, 6]
    fused_box = np.sum(boxes * scores[:, None], axis=0) / np.sum(scores)
    fused_score = np.sum(scores * weights) / np.sum(weights)
    return np.concatenate([fused_box, [fused_score, cluster[0, 5]]])


def weighted_boxes_fusion(boxes_list, weights=None, iou_thr: float = 0.5,
                          skip_box_thr: float = 0.0) -> np.ndarray:
    """Fuse per-model detection lists.

    boxes_list: one (N_i, 6) [x1, y1, x2, y2, score, cls] array per model
    (or TTA branch); weights: one weight per model (default 1). Returns
    (M, 6) fused detections, score descending."""
    if weights is None:
        weights = [1.0] * len(boxes_list)
    rows = []
    for dets, w in zip(boxes_list, weights):
        dets = np.asarray(dets, dtype=np.float64)
        if len(dets):
            dets = dets[dets[:, 4] > skip_box_thr]
        if len(dets):
            rows.append(np.concatenate([dets, np.full((len(dets), 1), w)], axis=1))
    if not rows:
        return np.zeros((0, 6))
    all_boxes = np.concatenate(rows, axis=0)

    fused_out = []
    for cls in np.unique(all_boxes[:, 5]):
        group = all_boxes[all_boxes[:, 5] == cls]
        clusters: list[list[np.ndarray]] = []
        fused: list[np.ndarray] = []
        for i in np.argsort(group[:, 4])[::-1]:
            cur = group[i]
            hit = (np.nonzero(pairwise_iou_np(cur[None, :4], np.asarray(fused)[:, :4])[0]
                              >= iou_thr)[0] if fused else [])
            if len(hit) == 0:
                clusters.append([cur])
                fused.append(_fuse_cluster(np.asarray([cur])))
            for j in hit:
                clusters[j].append(cur)
                fused[j] = _fuse_cluster(np.asarray(clusters[j]))
        fused_out.extend(fused)
    out = np.asarray(fused_out)
    return out[np.argsort(out[:, 4])[::-1]]
