"""On-device preprocess: letterbox (nearest resize + centred pad) and /255.

The host ships raw uint8 (B, H0, W0, 3); the device gathers rows and columns
through static index tables, fills the padding frame and normalises. The
index tables are cv2's INTER_NEAREST map, built in float64 on the host, so
the result is pixel-exact against ``letterbox_image``.
"""

from __future__ import annotations

import numpy as np
import torch

from .letterbox import LetterboxInfo

__all__ = ["device_letterbox_normalize", "letterbox_plan"]


def letterbox_plan(src_hw, dst_hw, stride: int = 32,
                   only_downscale: bool = False) -> LetterboxInfo:
    """Static letterbox geometry for a (src, dst) pair (training mode)."""
    src_h, src_w = src_hw
    dst_h, dst_w = dst_hw
    rem_h, rem_w = dst_h % stride, dst_w % stride
    dst_h += (stride - rem_h) if rem_h else 0
    dst_w += (stride - rem_w) if rem_w else 0
    scale = float(min(dst_h / src_h, dst_w / src_w))
    if only_downscale:
        scale = min(scale, 1.0)
    if scale != 1.0:
        new_h, new_w = int(src_h * scale), int(src_w * scale)
    else:
        new_h, new_w = src_h, src_w
    pad_h, pad_w = dst_h - new_h, dst_w - new_w
    top, left = pad_h // 2, pad_w // 2
    return LetterboxInfo(
        scale=scale, pad_top=top, pad_left=left,
        pad_bottom=pad_h - top, pad_right=pad_w - left,
        org_h=src_h, org_w=src_w,
    )


def _nearest_indices(dst_n: int, src_n: int) -> np.ndarray:
    """cv2 INTER_NEAREST source index per destination index:
    sx = floor(dx * src/dst), computed in float64, clipped."""
    idx = np.floor(
        np.arange(dst_n, dtype=np.float64) * (src_n / dst_n)
    ).astype(np.int64)
    return np.clip(idx, 0, src_n - 1)


def device_letterbox_normalize(img_u8: torch.Tensor, dst_hw, stride: int = 32,
                               fill_value: int = 114,
                               out_dtype=torch.float32,
                               normalize: bool = True,
                               only_downscale: bool = False) -> torch.Tensor:
    """uint8 (B, H0, W0, 3) -> (B, H, W, 3) ``out_dtype`` letterboxed
    (+ /255 when ``normalize``) on ``img_u8``'s device."""
    b, src_h, src_w, c = img_u8.shape
    info = letterbox_plan((src_h, src_w), dst_hw, stride, only_downscale)
    new_h = src_h if info.scale == 1.0 else int(src_h * info.scale)
    new_w = src_w if info.scale == 1.0 else int(src_w * info.scale)
    dst_h = info.pad_top + new_h + info.pad_bottom
    dst_w = info.pad_left + new_w + info.pad_right

    ys, xs = np.arange(dst_h), np.arange(dst_w)
    y_in = (ys >= info.pad_top) & (ys < info.pad_top + new_h)
    x_in = (xs >= info.pad_left) & (xs < info.pad_left + new_w)
    iy = np.zeros(dst_h, np.int64)
    iy[y_in] = _nearest_indices(new_h, src_h)
    ix = np.zeros(dst_w, np.int64)
    ix[x_in] = _nearest_indices(new_w, src_w)

    dev = img_u8.device
    gathered = img_u8.index_select(1, torch.from_numpy(iy).to(dev))
    gathered = gathered.index_select(2, torch.from_numpy(ix).to(dev))
    mask = (torch.from_numpy(y_in).to(dev)[None, :, None, None]
            & torch.from_numpy(x_in).to(dev)[None, None, :, None])
    fill = torch.tensor(fill_value, dtype=torch.uint8, device=dev)
    out = torch.where(mask, gathered, fill).to(out_dtype)
    if normalize:
        out = out / 255.0
    return out
