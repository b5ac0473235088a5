"""Augmentation settings and the post-augmentation box filter.

Only ``AugmentConfig`` (the data_hyp keys) and ``valid_boxes_mask`` of
``yoloseries_tpu/data/augment.py`` are here: the host augmenters (mosaic,
mixup, perspective, HSV, cutout, flips, blur) are not ported yet (ROADMAP
A6), and the port's loader serves samples without them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["AugmentConfig", "valid_boxes_mask"]


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    perspective_p: float = 1.0
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0005
    hsv_p: float = 1.0
    hsv_hgain: float = 0.015
    hsv_sgain: float = 0.7
    hsv_vgain: float = 0.4
    mixup_p: float = 0.3
    fliplr_p: float = 0.3
    flipud_p: float = 0.0
    fill_value: int = 114
    mosaic_p: float = 1.0
    cutout_p: float = 0.3
    cutout_iou_thr: float = 0.3
    scale_jitting_p: float = 0.0
    blur_p: float = 0.0
    input_size: tuple = (640, 640)  # (h, w)


def valid_boxes_mask(boxes, wh_thr=2, ar_thr=10, area_thr=16):
    """(N,) keep-mask of xyxy boxes: positive extent over ``wh_thr`` each
    way, area at least ``area_thr``, aspect ratio under ``ar_thr``."""
    boxes = np.asarray(boxes)
    if len(boxes) == 0:
        return np.zeros((0,), dtype=bool)
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    ar1 = w / (h + 1e-16)
    ar2 = h / (w + 1e-16)
    ar = np.where(ar1 > ar2, ar1, ar2)
    return (
        (boxes[:, 2] > boxes[:, 0])
        & (boxes[:, 3] > boxes[:, 1])
        & (w > wh_thr)
        & (h > wh_thr)
        & (w * h >= area_thr)
        & (ar < ar_thr)
    )
