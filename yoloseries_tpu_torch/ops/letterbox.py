"""Letterbox resize (host side, numpy) and its inverse for boxes.

Same geometry as the reference's training-mode letterbox: stride-rounded
destination, aspect-preserving scale, nearest-neighbour resize with cv2's
INTER_NEAREST index map, centred fill padding. The resize is a numpy gather
over the float64 index table of ``preprocess._nearest_indices`` so that no
image library is needed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["LetterboxInfo", "letterbox_image", "unletterbox_boxes_np"]


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


def letterbox_image(img: np.ndarray, dst_size, stride: int = 64,
                    fill_value: int = 128, only_downscale: bool = False):
    """Resize ``img`` (H, W, 3) uint8 keeping the aspect ratio and pad it to
    the full stride-aligned destination (training mode).

    Returns (padded uint8 image, LetterboxInfo).
    """
    from .preprocess import _nearest_indices, letterbox_plan

    if isinstance(dst_size, int):
        dst_size = (dst_size, dst_size)
    org_h, org_w = img.shape[:2]
    info = letterbox_plan((org_h, org_w), tuple(dst_size), stride, only_downscale)
    new_h = org_h if info.scale == 1.0 else int(org_h * info.scale)
    new_w = org_w if info.scale == 1.0 else int(org_w * info.scale)
    resized = img[_nearest_indices(new_h, org_h)][:, _nearest_indices(new_w, org_w)]
    out = np.full(
        (info.pad_top + new_h + info.pad_bottom,
         info.pad_left + new_w + info.pad_right, img.shape[2]),
        fill_value, dtype=np.uint8,
    )
    out[info.pad_top:info.pad_top + new_h, info.pad_left:info.pad_left + new_w] = resized
    return out, info


def unletterbox_boxes_np(boxes: np.ndarray, info: LetterboxInfo) -> np.ndarray:
    """Letterboxed xyxy boxes -> original-image coordinates, clipped."""
    out = np.asarray(boxes, dtype=np.float32).copy()
    out[..., [0, 2]] -= info.pad_left
    out[..., [1, 3]] -= info.pad_top
    out /= info.scale
    out[..., [0, 2]] = out[..., [0, 2]].clip(0, info.org_w)
    out[..., [1, 3]] = out[..., [1, 3]].clip(0, info.org_h)
    return out
