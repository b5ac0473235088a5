"""Host augmentation (numpy + cv2); counterpart of
``yoloseries_tpu/data/augment.py``.

Mosaic-of-4, mixup, the composed perspective warp with its box filter, the
HSV LUT jitter, flips, cutout, scale jitting, blur and YOCO, chained as the
reference's training transforms. Every function takes an explicit
``np.random.Generator`` and draws from it in the JAX package's order, so
one seed gives byte-identical samples in both packages on one machine.

cv2 does the pixel work exactly as the JAX package calls it
(``warpPerspective``/``warpAffine``, ``getRotationMatrix2D``,
``cvtColor`` + ``LUT``, ``addWeighted``, ``resize``, ``blur``). It is
imported inside the functions that use it (``import_cv2``), so importing the
port needs no cv2, and held to one thread: the loader forks its workers from
a process where cv2 has run, and a fork taken while one of cv2's pool
threads holds the pool's lock leaves a worker blocked for good in its first
parallel cv2 call (``warpAffine``). The results do not depend on the thread
count.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..ops.metrics import pairwise_iou_np

__all__ = [
    "AugmentConfig",
    "import_cv2",
    "mosaic4",
    "mixup",
    "random_perspective",
    "sample_perspective_params",
    "perspective_boxes",
    "random_hsv",
    "random_flip_lr",
    "random_flip_ud",
    "cutout",
    "scale_jitting",
    "random_blur",
    "yoco",
    "apply_transform_chain",
    "valid_boxes_mask",
]


def import_cv2():
    """cv2 with its thread pool off (``cv2.setNumThreads(1)``)."""
    import cv2

    if cv2.getNumThreads() != 1:
        cv2.setNumThreads(1)
    return cv2


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The data_hyp keys of ``configs/presets/train_yolov5.yaml``."""

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


def mosaic4(imgs, boxes_list, labels_list, mosaic_shape, fill_value, rng):
    """4-image mosaic on a (2h, 2w) canvas: each tile contributes its centre
    crop; boxes are clipped to the crop and kept at >= 0.3 area retention.
    Returns (img, boxes (N, 4), labels (N,)); when no box survives, the
    first tile unchanged with its own boxes."""
    if isinstance(mosaic_shape, int):
        mosaic_shape = [mosaic_shape, mosaic_shape]
    mh, mw = mosaic_shape

    yc = int(rng.uniform(2 * mh / 5, 4 * mh / 5))
    xc = int(rng.uniform(2 * mw / 5, 4 * mw / 5))
    out = np.full((mh, mw, 3), fill_value, dtype=np.uint8)
    boxes_out, labels_out = [], []

    for i, img in enumerate(imgs):
        h, w = img.shape[:2]
        if i == 0:
            xo1, yo1, xo2, yo2 = max(xc - w, 0), max(yc - h, 0), xc, yc
        elif i == 1:
            xo1, yo1, xo2, yo2 = xc, max(yc - h, 0), min(xc + w, mw), yc
        elif i == 2:
            xo1, yo1, xo2, yo2 = max(xc - w, 0), yc, xc, min(yc + h, mh)
        else:
            xo1, yo1, xo2, yo2 = xc, yc, min(xc + w, mw), min(yc + h, mh)

        cx, cy = w // 2, h // 2
        wi, hi = xo2 - xo1, yo2 - yo1
        dxi, dyi = wi // 2, hi // 2
        xi1, yi1 = cx - dxi, cy - dyi
        xi2, yi2 = cx + (wi - dxi), cy + (hi - dyi)
        out[yo1:yo2, xo1:xo2] = img[yi1:yi2, xi1:xi2]

        boxes = np.round(np.asarray(boxes_list[i], np.float32), 3)
        labels = np.asarray(labels_list[i])
        if len(boxes) == 0:
            continue
        crop = np.array([[xi1, yi1, xi2, yi2]], dtype=np.float32)
        keep = pairwise_iou_np(boxes, crop).squeeze(axis=1) > 0
        if keep.sum() == 0:
            continue
        b = boxes[keep].copy()
        orig_area = np.prod(boxes[keep][:, 2:4] - boxes[keep][:, 0:2], axis=1)
        b[:, [0, 2]] = np.clip(np.round(b[:, [0, 2]], 2), xi1, xi2 - 1) - xi1 + xo1
        b[:, [1, 3]] = np.clip(np.round(b[:, [1, 3]], 2), yi1, yi2 - 1) - yi1 + yo1
        cur_area = np.prod(b[:, 2:4] - b[:, 0:2], axis=1)
        retention = np.round(cur_area / orig_area, 1)
        valid = retention >= 0.3
        boxes_out.append(b[valid])
        labels_out.append(labels[keep][valid])

    if boxes_out:
        boxes_out = np.clip(np.concatenate(boxes_out, axis=0), 0, mh)
        labels_out = np.concatenate(labels_out, axis=0)
        return out, boxes_out, labels_out
    return imgs[0], np.asarray(boxes_list[0]), np.asarray(labels_list[0])


def mixup(img1, boxes1, labels1, img2, boxes2, labels2, rng):
    """Beta(8, 8) blend of two images (``cv2.addWeighted``, rounding), the
    union of their boxes."""
    cv2 = import_cv2()

    ratio = float(rng.beta(8.0, 8.0))
    img = cv2.addWeighted(img1, ratio, img2, 1.0 - ratio, 0.0)
    boxes = np.concatenate([boxes1, boxes2], axis=0)
    labels = np.concatenate([labels1, labels2], axis=0)
    return img, boxes, labels


def sample_perspective_params(src_shape, cfg: AugmentConfig, rng, dst_size):
    """Draw the composed warp matrix T @ S @ R @ P @ C and its scale."""
    cv2 = import_cv2()

    height, width = dst_size

    C = np.eye(3)
    C[0, 2] = -src_shape[1] / 2
    C[1, 2] = -src_shape[0] / 2

    P = np.eye(3)
    P[2, 0] = rng.uniform(-cfg.perspective, cfg.perspective)
    P[2, 1] = rng.uniform(-cfg.perspective, cfg.perspective)

    R = np.eye(3)
    a = rng.uniform(-cfg.degrees, cfg.degrees)
    s = rng.uniform(1 - cfg.scale, 1 + cfg.scale)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)

    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-cfg.shear, cfg.shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-cfg.shear, cfg.shear) * math.pi / 180)

    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - cfg.translate, 0.5 + cfg.translate) * width
    T[1, 2] = rng.uniform(0.5 - cfg.translate, 0.5 + cfg.translate) * height

    return T @ S @ R @ P @ C, s


def perspective_boxes(M, s, boxes, labels, width, height, use_perspective):
    """Warp boxes through M, clip them to the output and keep the
    candidates: sides over 2 px, area over 0.1 of the scaled original,
    aspect ratio under 20. Returns (boxes f32, labels)."""
    n = len(boxes)
    if not n:
        return boxes, labels
    xy = np.ones((n * 4, 3))
    xy[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
    xy = xy @ M.T
    if use_perspective:
        xy = (xy[:, :2] / xy[:, 2:3]).reshape(n, 8)
    else:
        xy = xy[:, :2].reshape(n, 8)
    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    new = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
    new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
    new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
    w1 = boxes[:, 2] - boxes[:, 0]
    h1 = boxes[:, 3] - boxes[:, 1]
    w2 = new[:, 2] - new[:, 0]
    h2 = new[:, 3] - new[:, 1]
    ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    keep = (
        (w2 > 2) & (h2 > 2)
        & (w2 * h2 / (w1 * s * h1 * s + 1e-16) > 0.1)
        & (ar < 20)
    )
    return new[keep].astype(np.float32), labels[keep]


def random_perspective(img, boxes, labels, cfg: AugmentConfig, rng, dst_size=None):
    """With probability ``perspective_p``: the composed centre / perspective
    / rotation / shear / translation warp into ``dst_size`` (default the
    input size), boxes warped and filtered."""
    if rng.random() >= cfg.perspective_p:
        return img, boxes, labels
    cv2 = import_cv2()

    if dst_size is None:
        dst_size = cfg.input_size
    height, width = dst_size

    M, s = sample_perspective_params(img.shape, cfg, rng, (height, width))
    fv = (cfg.fill_value,) * 3
    if cfg.perspective:
        img = cv2.warpPerspective(img, M, dsize=(width, height), borderValue=fv)
    else:
        img = cv2.warpAffine(img, M[:2], dsize=(width, height), borderValue=fv)

    boxes, labels = perspective_boxes(M, s, boxes, labels, width, height, bool(cfg.perspective))
    return img, boxes, labels


def random_hsv(img, p, hgain, sgain, vgain, rng):
    """With probability ``p``: hue, saturation and value gains through
    lookup tables."""
    if rng.random() >= p:
        return img
    cv2 = import_cv2()

    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    x = np.arange(0, 256, dtype=np.int16)
    lut_hue = ((x * r[0]) % 180).astype(img.dtype)
    lut_sat = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_val = np.clip(x * r[2], 0, 255).astype(img.dtype)
    hsv = cv2.merge((cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat), cv2.LUT(val, lut_val)))
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def random_flip_lr(img, boxes, p, rng):
    if rng.random() >= p:
        return img, boxes
    img = np.fliplr(img).copy()
    w = img.shape[1]
    out = boxes.copy()
    out[:, 0] = w - boxes[:, 2]
    out[:, 2] = w - boxes[:, 0]
    return img, out


def random_flip_ud(img, boxes, p, rng):
    if rng.random() >= p:
        return img, boxes
    img = np.flipud(img).copy()
    h = img.shape[0]
    out = boxes.copy()
    out[:, 1] = h - boxes[:, 3]
    out[:, 3] = h - boxes[:, 1]
    return img, out


def cutout(img, boxes, labels, iou_thr, p, rng):
    """With probability ``p``: 31 random masks of halving scales, each
    dropped where it would cover every box past ``iou_thr``; boxes covered
    past it are removed (all kept, image untouched, if none would stay)."""
    if rng.random() >= p:
        return img, boxes, labels
    scales = [0.5] + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 + [0.03125] * 16
    h, w = img.shape[:2]
    img_cut = img.copy()
    keep_mask = np.ones(len(boxes), dtype=bool)
    for s in scales:
        mh = int(rng.integers(1, max(int(h * s), 2)))
        mw = int(rng.integers(1, max(int(w * s), 2)))
        xc, yc = int(rng.integers(0, w)), int(rng.integers(0, h))
        x1 = max(0, min(xc - mw // 2, w))
        y1 = max(0, min(yc - mh // 2, h))
        x2 = max(0, min(xc + mw // 2, w))
        y2 = max(0, min(yc + mh // 2, h))
        mask_area = max((x2 - x1) * (y2 - y1), 0)
        if len(boxes):
            bw = np.maximum(boxes[:, 2] - boxes[:, 0], 0)
            bh = np.maximum(boxes[:, 3] - boxes[:, 1], 0)
            iw = np.clip(np.minimum(boxes[:, 2], x2) - np.maximum(boxes[:, 0], x1), 0, w)
            ih = np.clip(np.minimum(boxes[:, 3], y2) - np.maximum(boxes[:, 1], y1), 0, h)
            inter = iw * ih
            iou = inter / (mask_area + bw * bh - inter + 1e-16)
            bad = iou > iou_thr
            if bad.all():
                continue
            keep_mask &= ~bad
        img_cut[y1:y2, x1:x2] = [rng.integers(69, 200) for _ in range(3)]
    if keep_mask.sum() > 0:
        return img_cut, boxes[keep_mask], labels[keep_mask]
    return img, boxes, labels


def scale_jitting(img, boxes, labels, p, rng, dst_size=None):
    """With probability ``p``: a random up-scale (and a coin-flip mirror),
    then a random crop of ``dst_size`` (default the image's size)."""
    if rng.random() >= p:
        return img, boxes, labels
    cv2 = import_cv2()

    flip = rng.random() > 0.5
    if dst_size is None:
        dst_size = img.shape[:2]
    scale = min(img.shape[0] / dst_size[0], img.shape[1] / dst_size[1])
    base = max(dst_size[0] / img.shape[0], dst_size[1] / img.shape[1])
    jit = base + (rng.uniform(0.5, 1.5) if scale < 1.0 else rng.uniform(0.0, 0.5))

    rh, rw = int(img.shape[0] * jit), int(img.shape[1] * jit)
    resized = cv2.resize(np.ascontiguousarray(img), (rw, rh), interpolation=cv2.INTER_LINEAR)
    if flip:
        resized = resized[:, ::-1]
    y_off = rng.integers(0, rh - dst_size[0]) if rh > dst_size[0] else 0
    x_off = rng.integers(0, rw - dst_size[1]) if rw > dst_size[1] else 0
    img_out = resized[y_off:y_off + dst_size[0], x_off:x_off + dst_size[1]]

    b = boxes.copy() * jit
    if flip:
        x1 = rw - b[:, 2].copy()
        x2 = rw - b[:, 0].copy()
        b[:, 0], b[:, 2] = x1, x2
    b[:, [0, 2]] = np.clip(b[:, [0, 2]] - x_off, 0, dst_size[1])
    b[:, [1, 3]] = np.clip(b[:, [1, 3]] - y_off, 0, dst_size[0])
    ws = b[:, 2] - b[:, 0] + 1e-16
    hs = b[:, 3] - b[:, 1] + 1e-16
    ar = np.maximum(ws / hs, hs / ws)
    keep = (ar < 20) & (ws >= 3) & (hs >= 3)
    if keep.sum() > 0:
        return img_out, b[keep], np.asarray(labels)[keep]
    return img, boxes, labels


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


def random_blur(img, p, rng):
    """With probability ``p``: a 5x5 mean filter."""
    if rng.random() >= p:
        return img
    cv2 = import_cv2()

    return cv2.blur(img, (5, 5))


def yoco(img, aug_fn):
    """You-Only-Cut-Once: augment the top and bottom halves apart and join
    them (the reference's vertical split is unreachable, so only this one)."""
    h = img.shape[0]
    return np.concatenate((aug_fn(img[: h // 2]), aug_fn(img[h // 2:])), axis=0)


def apply_transform_chain(img, boxes, labels, cfg: AugmentConfig, rng):
    """The reference's transform chain: perspective -> cutout -> HSV -> blur
    -> flips -> scale jitting."""
    img, boxes, labels = random_perspective(img, boxes, labels, cfg, rng)
    img, boxes, labels = cutout(img, boxes, labels, cfg.cutout_iou_thr, cfg.cutout_p, rng)
    img = random_hsv(img, cfg.hsv_p, cfg.hsv_hgain, cfg.hsv_sgain, cfg.hsv_vgain, rng)
    img = random_blur(img, cfg.blur_p, rng)
    img, boxes = random_flip_lr(img, boxes, cfg.fliplr_p, rng)
    img, boxes = random_flip_ud(img, boxes, cfg.flipud_p, rng)
    img, boxes, labels = scale_jitting(img, boxes, labels, cfg.scale_jitting_p, rng)
    return img, boxes, labels
