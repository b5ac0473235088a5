"""Letterbox resize (host side, numpy) and its inverse for boxes.

Same geometry as the reference's training-mode letterbox: stride-rounded
destination, aspect-preserving scale, nearest-neighbour resize with cv2's
INTER_NEAREST index map, centred fill padding. The resize is a numpy gather
over ``cv2_nearest_indices`` so that no image library is needed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["LetterboxInfo", "cv2_nearest_indices", "letterbox_image", "letterbox_boxes",
           "unletterbox_boxes_np"]


@dataclass(frozen=True)
class LetterboxInfo:
    scale: float
    pad_top: int
    pad_left: int
    pad_bottom: int
    pad_right: int
    org_h: int
    org_w: int

    def as_array(self) -> np.ndarray:
        """[scale, pad_left, pad_top, org_w, org_h] as float32, so a batch of
        infos travels as one (B, 5) array."""
        return np.array(
            [self.scale, self.pad_left, self.pad_top, self.org_w, self.org_h],
            dtype=np.float32,
        )


def cv2_nearest_indices(dst_n: int, src_n: int) -> np.ndarray:
    """cv2 INTER_NEAREST source index per destination index, as cv2 computes
    it: sx = floor(dx * (1 / (dst / src))) in float64, clipped. The inverse
    of the ratio, not src / dst: the two differ in the last bit for some
    sizes, and then floor picks the neighbour (4.5% of the (src, dst) pairs
    with src < 400, dst < 200)."""
    idx = np.floor(np.arange(dst_n, dtype=np.float64) * (1.0 / (dst_n / src_n)))
    return np.clip(idx.astype(np.int64), 0, src_n - 1)


def letterbox_image(img: np.ndarray, dst_size, stride: int = 64,
                    fill_value: int = 128, only_downscale: bool = False):
    """Resize ``img`` (H, W, 3) uint8 keeping the aspect ratio and pad it to
    the full stride-aligned destination (training mode).

    Returns (padded uint8 image, LetterboxInfo).
    """
    from .preprocess import letterbox_plan

    if isinstance(dst_size, int):
        dst_size = (dst_size, dst_size)
    org_h, org_w = img.shape[:2]
    info = letterbox_plan((org_h, org_w), tuple(dst_size), stride, only_downscale)
    new_h = org_h if info.scale == 1.0 else int(org_h * info.scale)
    new_w = org_w if info.scale == 1.0 else int(org_w * info.scale)
    if (new_h, new_w) == (org_h, org_w):  # the index map is the identity: no gather
        resized = img
    else:
        resized = img[cv2_nearest_indices(new_h, org_h)][:, cv2_nearest_indices(new_w, org_w)]
    out = np.full(
        (info.pad_top + new_h + info.pad_bottom,
         info.pad_left + new_w + info.pad_right, img.shape[2]),
        fill_value, dtype=np.uint8,
    )
    out[info.pad_top:info.pad_top + new_h, info.pad_left:info.pad_left + new_w] = resized
    return out, info


def letterbox_boxes(boxes: np.ndarray, info: LetterboxInfo) -> np.ndarray:
    """Original-image xyxy boxes -> letterboxed coordinates."""
    out = np.asarray(boxes, dtype=np.float32) * info.scale
    out[..., [1, 3]] += info.pad_top
    out[..., [0, 2]] += info.pad_left
    return out


def unletterbox_boxes_np(boxes: np.ndarray, info: LetterboxInfo) -> np.ndarray:
    """Letterboxed xyxy boxes -> original-image coordinates, clipped."""
    out = np.asarray(boxes, dtype=np.float32).copy()
    out[..., [0, 2]] -= info.pad_left
    out[..., [1, 3]] -= info.pad_top
    out /= info.scale
    out[..., [0, 2]] = out[..., [0, 2]].clip(0, info.org_w)
    out[..., [1, 3]] = out[..., [1, 3]].clip(0, info.org_h)
    return out
