"""YOLOv5 anchor constants and the cell grid (numpy, host side)."""

from __future__ import annotations

import numpy as np

__all__ = ["YOLOV5_ANCHORS", "make_grid"]

# (stage, anchor, wh) in input-image pixels for strides 8/16/32.
YOLOV5_ANCHORS = np.array(
    [
        [[10, 13], [16, 30], [33, 23]],
        [[30, 61], [62, 45], [59, 119]],
        [[116, 90], [156, 198], [373, 326]],
    ],
    dtype=np.float32,
)


def make_grid(h: int, w: int) -> np.ndarray:
    """(h, w, 2) array of [x, y] cell coordinates."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([xs, ys], axis=-1).astype(np.float32)
