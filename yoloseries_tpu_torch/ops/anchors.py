"""Anchor constants and generators (numpy, host side).

* YOLOv5/v7's 3x3 anchors and the cell grid;
* RetinaNet's pyramid anchors: levels 3-7, size 2^(l+2), 3 ratios x 3
  scales a cell, centred on the cells of a ceil(img / 2^l) map; made once
  on the host, as in ``yoloseries_tpu/ops/anchors.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["YOLOV5_ANCHORS", "feature_map_shape", "level_anchors", "make_grid", "pyramid_anchors"]

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


def feature_map_shape(img_shape, pyramid_level: int) -> np.ndarray:
    """A conv pyramid's map shape at ``pyramid_level``: ceil(img / 2^level)."""
    img_shape = np.asarray(img_shape)
    return (img_shape - 1) // (2**pyramid_level) + 1


def _base_anchors(size: float, ratios: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """(A, 4) xyxy anchors centred at the origin, scales fastest."""
    num = len(scales) * len(ratios)
    out = np.zeros((num, 4))
    out[:, 2:] = size * np.tile(scales, (2, len(ratios))).T
    areas = out[:, 2] * out[:, 3]
    out[:, 2] = np.sqrt(areas / np.repeat(ratios, len(scales)))
    out[:, 3] = out[:, 2] * np.repeat(ratios, len(scales))
    out[:, 0::2] -= np.tile(out[:, 2], (2, 1)).T * 0.5
    out[:, 1::2] -= np.tile(out[:, 3], (2, 1)).T * 0.5
    return out


def level_anchors(level_hw, pyramid_levels=(3, 4, 5, 6, 7), ratios=(0.5, 1.0, 2.0),
                  scales=(1.0, 2 ** (1 / 3), 2 ** (2 / 3))) -> np.ndarray:
    """The anchors of maps of (H_l, W_l) ``level_hw`` at ``pyramid_levels``,
    (sum_l H_l*W_l*9, 4) xyxy f32: level by level, cells row-major, the
    anchor fastest."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    chunks = []
    for level, fm in zip(pyramid_levels, level_hw):
        stride = 2**level
        base = _base_anchors(2 ** (level + 2), ratios, scales)
        sx, sy = np.meshgrid((np.arange(0, fm[1]) + 0.5) * stride,
                             (np.arange(0, fm[0]) + 0.5) * stride)
        shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
        chunks.append((shifts[:, None, :] + base[None, :, :]).reshape(-1, 4))
    return np.concatenate(chunks, axis=0).astype(np.float32)


def pyramid_anchors(img_shape, pyramid_levels=(3, 4, 5, 6, 7), **kw) -> np.ndarray:
    """Every RetinaNet anchor of an (h, w) input: ``level_anchors`` of the
    ceil(img / 2^l) maps."""
    return level_anchors([feature_map_shape(img_shape, lv) for lv in pyramid_levels],
                         pyramid_levels, **kw)
