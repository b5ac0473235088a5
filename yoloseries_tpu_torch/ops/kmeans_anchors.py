"""K-means anchor estimation; a copy of ``yoloseries_tpu/ops/kmeans_anchors.py``
(numpy).

IoU-distance k-means over dataset box shapes — the tool used to produce the
9 YOLOv5 anchors. d(box, anchor) = 1 - IoU(wh, wh) with boxes aligned at a
common corner.
"""

from __future__ import annotations

import numpy as np

__all__ = ["kmeans_anchors"]


def _wh_iou(whs: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """(N, 2) x (K, 2) -> (N, K) IoU of corner-aligned boxes."""
    inter = np.minimum(whs[:, None, 0], anchors[None, :, 0]) * np.minimum(
        whs[:, None, 1], anchors[None, :, 1]
    )
    union = (
        whs[:, 0] * whs[:, 1]
    )[:, None] + (anchors[:, 0] * anchors[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def kmeans_anchors(whs, k: int = 9, iterations: int = 300, seed: int = 0):
    """Cluster (N, 2) box sizes into k anchors (sorted by area).

    Returns (anchors (k, 2), mean_best_iou). Use
    anchors.reshape(stages, -1, 2) for the per-stage table.
    """
    whs = np.asarray(whs, dtype=np.float64)
    whs = whs[(whs > 1).all(axis=1)]
    rng = np.random.default_rng(seed)
    anchors = whs[rng.choice(len(whs), size=k, replace=False)]

    assign = None
    for _ in range(iterations):
        iou = _wh_iou(whs, anchors)
        new_assign = np.argmax(iou, axis=1)
        if assign is not None and (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            members = whs[assign == j]
            if len(members):
                anchors[j] = np.median(members, axis=0)

    order = np.argsort(anchors[:, 0] * anchors[:, 1])
    anchors = anchors[order]
    best_iou = _wh_iou(whs, anchors).max(axis=1).mean()
    return anchors.astype(np.float32), float(best_iou)
