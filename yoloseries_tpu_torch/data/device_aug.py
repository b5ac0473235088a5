"""Training augmentation rendered on the card: the host plans, the card
renders; counterpart of ``yoloseries_tpu/data/device_aug.py``.

* The planner (``plan_sample``, numpy only, so it runs in the loader's
  forked workers) draws from the sample's rng exactly as
  ``DetectionDataset.get`` does and does the same box arithmetic (mosaic
  placement, the warp's matrix, the box filters, cutout, flips, jitter,
  the resample loop), but no pixel work. It returns a small record of
  scalars, the boxes and labels (bit-identical to the host pipeline's),
  and either the crops of up to 8 tiles (``with_pixels``) or, for the
  image cache on the card, the ids and storage origins of those tiles.
* The renderer (``render_batch``, PyTorch, on the tensors' device) maps
  every output pixel back through letterbox, flips, the warp's inverse
  (cv2's 1/32 fixed point) and the mosaic tiles, samples both mixup layers
  bilinearly, blends them, paints cutout and applies the HSV jitter; blur
  and scale jitting go through a staged path that renders the sample
  plane first. No mosaic canvas is ever made.

The render keeps the JAX package's arithmetic op for op (the same
association of every sum and product, half-to-even rounding, the floored
``remainder``, integer casts after the clips), so it is byte-identical to
the JAX render run op by op. Against the cv2 host pipeline the pixels
agree to the bounds of ``tests/test_torch_port_device_aug.py``: exact on
copy, flip and cutout, last-bit rounding where warp, HSV or mixup enter.

``device_aug_supported`` is the loader's gate: blur and scale jitting need
the staged path, whose plane must fit the tile buffer (``perspective_p``
1, the reference default, or mosaic off); the loader falls back to host
augmentation otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .augment import AugmentConfig, perspective_boxes, sample_perspective_params, valid_boxes_mask

__all__ = ["plan_sample", "render_batch", "render_method", "render_staged", "repack_tiles",
           "device_aug_supported", "N_TILES", "N_CUTOUT"]

N_TILES = 8  # 4 tiles of mosaic layer A + 4 of layer B (mixup); a one-image plan uses tile 0
N_CUTOUT = 31  # cutout's masks: len(_CUTOUT_SCALES)

_CUTOUT_SCALES = [0.5] + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 + [0.03125] * 16


def device_aug_supported(cfg: AugmentConfig) -> bool:
    """True when every active knob renders on the card: blur and scale
    jitting need the staged path, whose sample plane must fit the tile
    buffer (every sample warped, or mosaic off)."""
    if cfg.blur_p == 0.0 and cfg.scale_jitting_p == 0.0:
        return True
    return cfg.perspective_p >= 1.0 or cfg.mosaic_p == 0.0


def render_staged(cfg: AugmentConfig) -> bool:
    """Whether ``render_batch`` needs the staged path for this config."""
    return cfg.blur_p > 0.0 or cfg.scale_jitting_p > 0.0


def render_method(cfg: AugmentConfig) -> str:
    """``"separable"`` when the warp is diagonal-affine (no rotation, shear
    or perspective: canvas x depends on the output column only, y on the
    row only, so every access is a row or column gather), else
    ``"gather"`` (a flat per-pixel gather per tap)."""
    diag = cfg.degrees == 0.0 and cfg.shear == 0.0 and cfg.perspective == 0.0
    return "separable" if diag else "gather"


# ------------------------------------------------------------- planner

def _empty_plan(th, tw, with_pixels=True):
    plan = {
        "rects": np.zeros((N_TILES, 4), np.float32),
        "minv": np.eye(3, dtype=np.float32),
        "mix": np.float32(1.0),
        "hsv": np.ones((3,), np.float32),
        "flips": np.zeros((2,), np.float32),
        "plane_wh": np.zeros((2,), np.float32),
        "cut_rects": np.zeros((N_CUTOUT, 4), np.float32),
        "cut_colors": np.zeros((N_CUTOUT, 3), np.float32),
        "cut_on": np.zeros((N_CUTOUT,), np.float32),
        # the staged path's knobs (blur, scale jitting), neutral when off
        "blur_on": np.float32(0.0),
        "jit_on": np.float32(0.0),
        "jit": np.float32(1.0),
        "jit_flip": np.float32(0.0),
        "jit_off": np.zeros((2,), np.float32),
    }
    if with_pixels:
        plan["tiles"] = np.zeros((N_TILES, th, tw, 3), np.uint8)
    else:  # the pixels stay in the image cache on the card
        plan["img_ids"] = np.zeros((N_TILES,), np.int32)
        plan["tile_off"] = np.zeros((N_TILES, 2), np.float32)
        plan["_tile_hw"] = (th, tw)
    return plan


def _place_tile(plan, t, img, crop, rect, xc, yc, img_id=-1):
    """Place the crop ``crop`` (xyxy, image coords) of ``img`` into tile
    ``t`` with half-aligned storage: a tile left of the split (xc, yc) is
    right-aligned (local x = canvas x + tw - xc), one above it
    bottom-aligned, the others left/top-aligned (local = canvas - xc/yc).
    The canvas-to-local offset is then a constant per half, known from the
    rects alone. A pixel plan copies the crop's pixels; a cache plan
    records the image id and the image coords of the storage origin."""
    if "tiles" in plan:
        th, tw = plan["tiles"].shape[1:3]
    else:
        th, tw = plan["_tile_hw"]
    xo1, yo1, xo2, yo2 = rect
    xi1, yi1 = crop[0], crop[1]
    xs0 = xo1 + (tw - xc if xo2 <= xc else -xc)
    ys0 = yo1 + (th - yc if yo2 <= yc else -yc)
    plan["rects"][t] = rect
    if "tiles" in plan:
        plan["tiles"][t, ys0:ys0 + (yo2 - yo1), xs0:xs0 + (xo2 - xo1)] = \
            img[yi1:yi1 + (yo2 - yo1), xi1:xi1 + (xo2 - xo1)]
    else:
        plan["img_ids"][t] = img_id
        plan["tile_off"][t] = (xi1 - xs0, yi1 - ys0)  # storage row j holds image row j + y0


def _plan_mosaic(dataset, idx, rng, plan, layer):
    """``DetectionDataset._mosaic`` + ``augment.mosaic4`` without the
    canvas: the same draws and box arithmetic; each tile's crop goes into
    the plan's tile ``4 * layer + i`` with its canvas rect."""
    indices = [idx] + [int(rng.integers(0, len(dataset))) for _ in range(3)]
    rng.shuffle(indices)
    if "tiles" in plan:
        pulled = [(img, img.shape[:2], b, l)
                  for img, b, l in (dataset.pull_item(i) for i in indices)]
    else:  # a cache plan reads no pixels on the host
        pulled = [(None, *dataset.pull_meta(i)) for i in indices]

    mh, mw = (2 * s for s in dataset.input_size)
    yc = int(rng.uniform(2 * mh / 5, 4 * mh / 5))
    xc = int(rng.uniform(2 * mw / 5, 4 * mw / 5))
    boxes_out, labels_out = [], []
    t0 = 4 * layer

    th, tw = dataset.input_size  # the tile buffer's shape
    for i, (img, (h, w), boxes, labels) in enumerate(pulled):
        if h > th or w > tw:
            raise ValueError(
                f"device_aug needs images that fit the tile buffer ({th}x{tw}); got {h}x{w}. "
                "Enable cache_images=True (min-scale resize) or pre-size the dataset.")
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

        _place_tile(plan, t0 + i, img, (xi1, yi1, xi2, yi2), (xo1, yo1, xo2, yo2), xc, yc,
                    img_id=indices[i])

        boxes = np.round(np.asarray(boxes, np.float32), 3)
        labels = np.asarray(labels)
        if len(boxes) == 0:
            continue
        # boxes overlapping the crop (IoU > 0 iff both overlaps are positive)
        keep = ((np.minimum(boxes[:, 2], xi2) - np.maximum(boxes[:, 0], xi1) > 0)
                & (np.minimum(boxes[:, 3], yi2) - np.maximum(boxes[:, 1], yi1) > 0))
        if keep.sum() == 0:
            continue
        bk = boxes[keep]
        b = bk.copy()
        orig_area = (bk[:, 2] - bk[:, 0]) * (bk[:, 3] - bk[:, 1])
        b[:, [0, 2]] = np.minimum(np.maximum(np.round(b[:, [0, 2]], 2), xi1), xi2 - 1) - xi1 + xo1
        b[:, [1, 3]] = np.minimum(np.maximum(np.round(b[:, [1, 3]], 2), yi1), yi2 - 1) - yi1 + yo1
        cur_area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        retention = np.round(cur_area / orig_area, 1)
        valid = retention >= 0.3
        boxes_out.append(b[valid])
        labels_out.append(labels[keep][valid])

    if boxes_out:
        boxes = np.clip(np.concatenate(boxes_out, axis=0), 0, mh)
        labels = np.concatenate(labels_out, axis=0)
        return (mh, mw), boxes, labels, True
    # no box survived (mosaic4's fall-back): the first pulled item as a
    # one-image plane, placed as a top-left tile with xc=w, yc=h
    img, (h, w), boxes, labels = pulled[0]
    if "tiles" in plan:
        plan["tiles"][t0:t0 + 4] = 0
    plan["rects"][t0:t0 + 4] = 0.0
    _place_tile(plan, t0, img, (0, 0, w, h), (0, 0, w, h), w, h, img_id=indices[0])
    return (h, w), np.asarray(boxes), np.asarray(labels), False


def _plan_chain(plan, boxes, labels, plane_hw, cfg: AugmentConfig, rng):
    """``augment.apply_transform_chain`` without the pixel work:
    perspective, cutout, HSV, (blur's draw), flips, (jitter's draws)."""
    h0, w0 = plane_hw

    if rng.random() < cfg.perspective_p:
        height, width = cfg.input_size
        M, s = sample_perspective_params((h0, w0), cfg, rng, (height, width))
        boxes, labels = perspective_boxes(M, s, boxes, labels, width, height,
                                          bool(cfg.perspective))
        plan["minv"] = np.linalg.inv(M).astype(np.float32)
        plane_hw = (height, width)
    h, w = plane_hw
    plan["plane_wh"] = np.asarray([w, h], np.float32)

    # cutout: rects and colours in paint order (the renderer: later mask wins)
    if rng.random() < cfg.cutout_p:
        keep_mask = np.ones(len(boxes), dtype=bool)
        painted_any = False
        m = 0
        for s_ in _CUTOUT_SCALES:
            mh = int(rng.integers(1, max(int(h * s_), 2)))
            mw = int(rng.integers(1, max(int(w * s_), 2)))
            xc, yc = int(rng.integers(0, w)), int(rng.integers(0, h))
            x1 = max(0, min(xc - mw // 2, w))
            y1 = max(0, min(yc - mh // 2, h))
            x2 = max(0, min(xc + mw // 2, w))
            y2 = max(0, min(yc + mh // 2, h))
            mask_area = max((x2 - x1) * (y2 - y1), 0)
            if len(boxes):
                bw = np.maximum(boxes[:, 2] - boxes[:, 0], 0)
                bh = np.maximum(boxes[:, 3] - boxes[:, 1], 0)
                iw = np.minimum(np.maximum(
                    np.minimum(boxes[:, 2], x2) - np.maximum(boxes[:, 0], x1), 0), w)
                ih = np.minimum(np.maximum(
                    np.minimum(boxes[:, 3], y2) - np.maximum(boxes[:, 1], y1), 0), h)
                inter = iw * ih
                iou = inter / (mask_area + bw * bh - inter + 1e-16)
                bad = iou > cfg.cutout_iou_thr
                if bad.all():
                    continue
                keep_mask &= ~bad
            color = [rng.integers(69, 200) for _ in range(3)]
            plan["cut_rects"][m] = (x1, y1, x2, y2)
            plan["cut_colors"][m] = color
            plan["cut_on"][m] = 1.0
            m += 1
            painted_any = True
        if painted_any and keep_mask.sum() > 0:
            boxes, labels = boxes[keep_mask], labels[keep_mask]
        elif painted_any:  # the reference keeps the uncut image when every box would go
            plan["cut_on"][:] = 0.0

    if rng.random() < cfg.hsv_p:
        r = rng.uniform(-1, 1, 3) * [cfg.hsv_hgain, cfg.hsv_sgain, cfg.hsv_vgain] + 1
        plan["hsv"] = r.astype(np.float32)

    if rng.random() < cfg.blur_p:
        plan["blur_on"] = np.float32(1.0)

    if rng.random() < cfg.fliplr_p:
        plan["flips"][0] = 1.0
        if len(boxes):
            out = boxes.copy()
            out[:, 0] = w - boxes[:, 2]
            out[:, 2] = w - boxes[:, 0]
            boxes = out
    if rng.random() < cfg.flipud_p:
        plan["flips"][1] = 1.0
        if len(boxes):
            out = boxes.copy()
            out[:, 1] = h - boxes[:, 3]
            out[:, 3] = h - boxes[:, 1]
            boxes = out

    # scale jitting with dst_size the plane itself: the same draws and box math
    if rng.random() < cfg.scale_jitting_p:
        jflip = rng.random() > 0.5
        scale = 1.0
        base = 1.0
        jit = base + (rng.uniform(0.5, 1.5) if scale < 1.0 else rng.uniform(0.0, 0.5))
        rh, rw = int(h * jit), int(w * jit)
        y_off = int(rng.integers(0, rh - h)) if rh > h else 0
        x_off = int(rng.integers(0, rw - w)) if rw > w else 0
        b = boxes.copy() * jit
        if len(b) and jflip:
            x1 = rw - b[:, 2].copy()
            x2 = rw - b[:, 0].copy()
            b[:, 0], b[:, 2] = x1, x2
        if len(b):
            b[:, [0, 2]] = np.minimum(np.maximum(b[:, [0, 2]] - x_off, 0), w)
            b[:, [1, 3]] = np.minimum(np.maximum(b[:, [1, 3]] - y_off, 0), h)
            ws = b[:, 2] - b[:, 0] + 1e-16
            hs = b[:, 3] - b[:, 1] + 1e-16
            ar = np.maximum(ws / hs, hs / ws)
            keep = (ar < 20) & (ws >= 3) & (hs >= 3)
        else:
            keep = np.zeros((0,), dtype=bool)
        if keep.sum() > 0:
            boxes, labels = b[keep], labels[keep]
            plan["jit_on"] = np.float32(1.0)
            plan["jit"] = np.float32(jit)
            plan["jit_flip"] = np.float32(jflip)
            plan["jit_off"] = np.asarray([x_off, y_off], np.float32)
        # else the reference keeps the unjittered image and boxes

    return plan, boxes, labels, plane_hw


def plan_sample(dataset, idx: int, rng: np.random.Generator, with_pixels: bool = True):
    """One augmented sample's plan, drawing from ``rng`` as
    ``dataset.get(idx, rng, enable_aug=True)`` does, so its boxes and
    labels equal the host pipeline's.

    ``with_pixels=False`` makes a cache plan: image ids and storage
    origins instead of tiles, for a render against the image cache on the
    card (the dataset must have ``cache_images``).

    Returns (plan dict, boxes (N, 4) xyxy in the sample plane, labels (N,),
    plane_hw): the plane is what the host pipeline would hand to the
    collate (the warped image, the unwarped mosaic canvas or the item).
    """
    th, tw = dataset.input_size

    for _attempt in range(10):
        plan = _empty_plan(th, tw, with_pixels)
        if with_pixels:
            img, boxes, labels = dataset.pull_item(idx)
            plane_hw = img.shape[:2]
        else:
            img = None
            plane_hw, boxes, labels = dataset.pull_meta(idx)
        if rng.random() < dataset.aug.mosaic_p:
            plane_hw, boxes, labels, ok = _plan_mosaic(dataset, idx, rng, plan, 0)
            if rng.random() < dataset.aug.mixup_p:
                idx2 = int(rng.integers(0, len(dataset)))
                _, b2, l2, ok2 = _plan_mosaic(dataset, idx2, rng, plan, 1)
                ratio = float(rng.beta(8.0, 8.0))
                if ok and ok2:  # mixup blends two 2s x 2s canvases
                    plan["mix"] = np.float32(ratio)
                    boxes = np.concatenate([boxes, b2], axis=0)
                    labels = np.concatenate([labels, l2], axis=0)
                # planes of a fall-back mosaic can differ in size: no blend
        else:
            h, w = plane_hw
            if h > th or w > tw:
                raise ValueError(
                    f"device_aug needs images that fit the tile buffer ({th}x{tw}); got "
                    f"{h}x{w}. Enable cache_images=True (min-scale resize) or pre-size the "
                    "dataset.")
            _place_tile(plan, 0, img, (0, 0, w, h), (0, 0, w, h), w, h, img_id=idx)

        plan, boxes, labels, plane_hw = _plan_chain(
            plan, np.asarray(boxes, np.float32), np.asarray(labels), plane_hw, dataset.aug, rng)

        if len(boxes):
            keep = valid_boxes_mask(boxes)
            boxes, labels = boxes[keep], labels[keep]
        if len(boxes) and boxes.sum() > 0:
            plan.pop("_tile_hw", None)
            return plan, boxes.astype(np.float32), labels.astype(np.float32), plane_hw
        idx = int(rng.integers(0, len(dataset)))

    # give up augmenting (as ``get`` does): the raw item as a one-tile plan
    plan = _empty_plan(th, tw, with_pixels)
    if with_pixels:
        img, boxes, labels = dataset.pull_item(idx)
        h, w = img.shape[:2]
    else:
        img = None
        (h, w), boxes, labels = dataset.pull_meta(idx)
    _place_tile(plan, 0, img, (0, 0, w, h), (0, 0, w, h), w, h, img_id=idx)
    plan["plane_wh"] = np.asarray([w, h], np.float32)
    plan.pop("_tile_hw", None)
    return plan, boxes.astype(np.float32), labels.astype(np.float32), (h, w)


# ------------------------------------------------------------ renderer

def _const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``c`` as a 0-d tensor on ``x``'s device, made by a fill (no copy from
    the host). Dividing by it is a true division on the card too, where
    PyTorch multiplies by the reciprocal of a Python number."""
    return x.new_full((), c)


def _rgb_to_hsv_u8(rgb):
    """cv2's uint8 RGB2HSV: H in [0, 180), S and V in [0, 255]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    s = torch.where(v > 0, torch.round(255.0 * diff / v.clamp_min(1e-9)), 0.0)
    safe = diff.clamp_min(1e-9)
    h = torch.where(v == r, 60.0 * (g - b) / safe,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                                240.0 + 60.0 * (r - g) / safe))
    h = torch.where(diff == 0, 0.0, h)
    h = torch.where(h < 0, h + 360.0, h)
    return torch.round(h / 2.0), s, v


def _hsv_to_rgb_u8(h, s, v):
    """The inverse of cv2's uint8 HSV: h in [0, 180), s and v in [0, 255]."""
    h = h * 2.0  # degrees
    c = v * (s / _const(s, 255.0))
    hp = h / _const(h, 60.0)
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    m = v - c
    z = torch.zeros_like(c)
    i = torch.floor(hp).to(torch.int32) % 6  # the sector; its (r, g, b) below
    r = torch.where((i == 0) | (i == 5), c, torch.where((i == 1) | (i == 4), x, z))
    g = torch.where((i == 0) | (i == 3), x, torch.where((i == 1) | (i == 2), c, z))
    b = torch.where((i == 2) | (i == 5), x, torch.where((i == 3) | (i == 4), c, z))
    return torch.stack([r + m, g + m, b + m], dim=-1)


def _halved(rects, field, right, bottom):
    """``rects[:, t, field]`` of the mosaic tile t = right + 2 * bottom at
    each point of the broadcast of ``right`` and ``bottom``."""
    r = rects[..., field]  # (B, 4)

    def bc(t):
        return r[:, t].reshape(r.shape[0], *([1] * (right.ndim - 1)))

    return torch.where(bottom, torch.where(right, bc(3), bc(2)),
                       torch.where(right, bc(1), bc(0)))


def _sample_layer(tiles_px, base, rects, u, v, th, tw, fill):
    """Bilinear sample of one mosaic layer at canvas coords (u, v), the
    general (projective) path: 4 taps, each resolved to its tile and
    gathered per pixel. Uncovered canvas reads ``fill``; the coords are
    quantized to 1/32 as cv2's warp does.

    tiles_px: (B * 8 * th * tw, 3) uint8, every plan's tiles; base: (B, 1,
    1) int64, the first pixel of this layer's tiles; rects: (B, 4, 4); u,
    v: (B, H, W) f32. Returns (B, H, W, 3) f32."""
    u = torch.round(u * 32.0) / 32.0
    v = torch.round(v * 32.0) / 32.0
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0

    b = rects.shape[0]
    xc = rects[:, 0, 2].reshape(b, *([1] * (u.ndim - 1)))  # the 2x2 split
    yc = rects[:, 0, 3].reshape(b, *([1] * (u.ndim - 1)))

    out = None
    for du, dv, wgt in ((0.0, 0.0, (1 - fu) * (1 - fv)), (1.0, 0.0, fu * (1 - fv)),
                        (0.0, 1.0, (1 - fu) * fv), (1.0, 1.0, fu * fv)):
        uu = u0 + du  # integer-valued canvas coords
        vv = v0 + dv
        right = uu >= xc
        bottom = vv >= yc
        hit = ((_halved(rects, 0, right, bottom) <= uu) & (uu < _halved(rects, 2, right, bottom))
               & (_halved(rects, 1, right, bottom) <= vv)
               & (vv < _halved(rects, 3, right, bottom)))
        lx = torch.clamp(uu + torch.where(right, -xc, tw - xc), 0, tw - 1)
        ly = torch.clamp(vv + torch.where(bottom, -yc, th - yc), 0, th - 1)
        tile_id = right.long() + 2 * bottom.long()
        flat = base + (tile_id * th + ly.long()) * tw + lx.long()
        tap = torch.where(hit[..., None], tiles_px[flat].float(), fill)
        term = wgt[..., None] * tap
        out = term if out is None else out + term
    return out


def _sample_layer_separable(tiles, rects, u, v, th, tw, fill):
    """Bilinear sample of one mosaic layer when the warp is diagonal-affine:
    u (B, W) per column, v (B, H) per row, so every access is a gather of
    whole tile rows, then of row-invariant columns. The taps, weights,
    coverage and 1/32 quantization are those of ``_sample_layer``.

    tiles: (B, 4, th, tw, 3) uint8; rects: (B, 4, 4). Returns (B, H, W, 3)
    f32."""
    b = tiles.shape[0]
    stacked = tiles.reshape(b, 4 * th, tw, 3)
    bi = torch.arange(b, device=tiles.device)[:, None]

    u = torch.round(u * 32.0) / 32.0
    v = torch.round(v * 32.0) / 32.0
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    xc = rects[:, 0, 2:3]  # (B, 1)
    yc = rects[:, 0, 3:4]

    val = cov = None
    for dv, wv in ((0.0, 1 - fv), (1.0, fv)):  # row taps, (B, H)
        vv = v0 + dv
        bottom = vv >= yc
        ly = torch.clamp(vv + torch.where(bottom, -yc, th - yc), 0, th - 1)
        half_rows, hity = [], []
        for hx in (0, 1):  # the left and the right tile of this row's half
            row_idx = (hx + 2 * bottom.long()) * th + ly.long()
            half_rows.append(stacked[bi, row_idx])  # (B, H, tw, 3)
            ylo = torch.where(bottom, rects[:, 2 + hx, 1:2], rects[:, hx, 1:2])
            yhi = torch.where(bottom, rects[:, 2 + hx, 3:4], rects[:, hx, 3:4])
            hity.append((ylo <= vv) & (vv < yhi))
        cat = torch.cat(half_rows, dim=2)  # (B, H, 2 * tw, 3)

        for du, wu in ((0.0, 1 - fu), (1.0, fu)):  # column taps, (B, W)
            uu = u0 + du
            right = uu >= xc
            lx = torch.clamp(uu + torch.where(right, -xc, tw - xc), 0, tw - 1)
            col_idx = right.long() * tw + lx.long()  # (B, W), the same for every row
            pix = torch.gather(cat, 2, col_idx[:, None, :, None].expand(
                -1, cat.shape[1], -1, 3)).float()
            right_n = right[:, None, :]
            bottom_n = bottom[:, :, None]
            xlo = _halved(rects, 0, right_n, bottom_n)
            xhi = _halved(rects, 2, right_n, bottom_n)
            hitx = (xlo <= uu[:, None, :]) & (uu[:, None, :] < xhi)
            hity_sel = torch.where(right_n, hity[1][:, :, None], hity[0][:, :, None])
            wgt = wv[:, :, None] * wu[:, None, :] * (hitx & hity_sel).float()
            term = wgt[..., None] * pix
            val = term if val is None else val + term
            cov = wgt if cov is None else cov + wgt
    return val + fill * (1.0 - cov)[..., None]


def repack_tiles(cache, img_ids, tile_off):
    """The half-aligned (B, 8, th, tw, 3) tile buffer made on the card from
    the image cache: a gather of whole rows, then of row-invariant columns.

    cache: (N, th, tw, 3) uint8; img_ids: (B, 8) int; tile_off: (B, 8, 2)
    f32, the image coords (x, y) of each tile's storage origin. Storage
    positions outside the crop read clipped pixels of the image; the
    renderer's rect test never samples them."""
    n, th, tw, _ = cache.shape
    b = img_ids.shape[0]
    flat = cache.reshape(n * th, tw, 3)
    iy0 = tile_off[..., 1].long()  # (B, 8)
    ix0 = tile_off[..., 0].long()
    rows = torch.clamp(iy0[..., None] + torch.arange(th, device=cache.device), 0, th - 1)
    ridx = img_ids.long()[..., None] * th + rows  # (B, 8, th)
    g = flat[ridx.reshape(-1)].reshape(b, N_TILES, th, tw, 3)
    cols = torch.clamp(ix0[..., None] + torch.arange(tw, device=cache.device), 0, tw - 1)
    return torch.gather(g, 3, cols[:, :, None, :, None].expand(-1, -1, th, -1, 3))


def render_batch(tiles, plan, out_hw, tile_hw, fill=114, lb_fill=114, method="gather",
                 cache=None, staged=False):
    """Render a batch of plans to (B, H, W, 3) uint8 on the plan's device.

    tiles: (B, 8, th, tw, 3) uint8 (pixel plans), or None with ``cache``,
    the (N, th, tw, 3) uint8 image cache, for plans that carry ``img_ids``
    and ``tile_off``: the tiles are then repacked from the cache.
    plan: the batched fields of ``collate_plan_batch`` as tensors: minv (B,
    3, 3), rects (B, 8, 4), mix (B,), hsv (B, 3), flips (B, 2), plane_wh
    (B, 2), lbox (B, 3) [scale, pad_left, pad_top], cut_rects (B, 31, 4),
    cut_colors (B, 31, 3), cut_on (B, 31), blur_on, jit_on, jit, jit_flip
    (B,), jit_off (B, 2).
    method: ``render_method(cfg)``; staged: ``render_staged(cfg)``."""
    if cache is not None:
        tiles = repack_tiles(cache, plan["img_ids"], plan["tile_off"])
    return _render_batch(tiles, plan, tuple(out_hw), tuple(tile_hw), fill, lb_fill, method,
                         staged)


def _warp_and_sample(tiles, plan, fx, fy, th, tw, fill, method):
    """The plane's value at plane coords fx ((B|1), 1, W), fy ((B|1), H,
    1): through the warp's inverse, both layers sampled, blended and
    rounded. Returns (B, H, W, 3) f32."""
    minv = plan["minv"]
    rects = plan["rects"]
    if method == "separable":  # u is a function of the column, v of the row
        u = minv[:, 0, 0][:, None] * fx[:, 0, :] + minv[:, 0, 2][:, None]
        v = minv[:, 1, 1][:, None] * fy[:, :, 0] + minv[:, 1, 2][:, None]
        layers = [_sample_layer_separable(tiles[:, 4 * i:4 * i + 4], rects[:, 4 * i:4 * i + 4],
                                          u, v, th, tw, float(fill)) for i in (0, 1)]
    else:
        m = [[minv[:, r, c][:, None, None] for c in range(3)] for r in range(3)]
        u = m[0][0] * fx + m[0][1] * fy + m[0][2]
        v = m[1][0] * fx + m[1][1] * fy + m[1][2]
        w_ = m[2][0] * fx + m[2][1] * fy + m[2][2]
        u = u / w_
        v = v / w_
        b = tiles.shape[0]
        tiles_px = tiles.reshape(-1, 3)
        first = torch.arange(b, device=tiles.device).reshape(b, 1, 1) * (N_TILES * th * tw)
        layers = [_sample_layer(tiles_px, first + 4 * i * th * tw, rects[:, 4 * i:4 * i + 4],
                                u, v, th, tw, float(fill)) for i in (0, 1)]
    ratio = plan["mix"][:, None, None, None]  # mixup, blended after sampling
    return torch.round(ratio * layers[0] + (1.0 - ratio) * layers[1])


def _pointwise_chain(val, plan, fx, fy):
    """Cutout paint and HSV jitter at plane coords fx, fy (broadcastable to
    (B, H, W)): pointwise, so it commutes with the nearest letterbox."""
    cr, cc = plan["cut_rects"], plan["cut_colors"]
    on = (plan["cut_on"] > 0)[:, :, None]  # (B, 31, 1)
    x, y = fx[:, 0, :][:, None, :], fy[:, :, 0][:, None, :]  # (B|1, 1, W), (B|1, 1, H)
    bit = torch.ones((), dtype=torch.int32, device=val.device) << torch.arange(
        N_CUTOUT, device=val.device, dtype=torch.int32)[None, :, None]
    # per column and per row, the masks (one bit each) whose span covers it
    bx = torch.where(on & (cr[:, :, 0:1] <= x) & (x < cr[:, :, 2:3]), bit, 0).sum(1)  # (B, W)
    by = torch.where(on & (cr[:, :, 1:2] <= y) & (y < cr[:, :, 3:4]), bit, 0).sum(1)  # (B, H)
    hits = by[:, :, None] & bx[:, None, :]  # (B, H, W): the masks painting each pixel
    # masks paint in order, so the highest one that hits wins
    top = torch.frexp(hits.double()).exponent.clamp_min(1) - 1
    bi = torch.arange(cc.shape[0], device=val.device)[:, None, None]
    val = torch.where((hits != 0)[..., None], cc[bi, top.long()], val)

    # HSV jitter (cv2's LUT semantics: truncation after the gain, hue mod 180)
    r = plan["hsv"]
    hsv_on = (r != 1.0).any(dim=1)[:, None, None]
    h, s, vch = _rgb_to_hsv_u8(val)
    h2 = torch.floor(torch.remainder(h * r[:, 0][:, None, None], 180.0))
    s2 = torch.floor(torch.clamp(s * r[:, 1][:, None, None], 0, 255))
    v2 = torch.floor(torch.clamp(vch * r[:, 2][:, None, None], 0, 255))
    rgb2 = torch.round(_hsv_to_rgb_u8(h2, s2, v2))
    return torch.where(hsv_on[..., None], rgb2, val)


def _blur5(plane, plan):
    """cv2.blur with a 5x5 box where the plan's blur fired: reflect-101
    borders at each sample's plane edge, floor(sum / 25 + 0.5). Five row
    gathers, then five column gathers."""
    b, th, tw, _ = plane.shape
    pw = plan["plane_wh"][:, 0:1]  # (B, 1)
    ph = plan["plane_wh"][:, 1:2]
    bi = torch.arange(b, device=plane.device)

    def refl(i, n):
        period = torch.clamp_min(2.0 * n - 2.0, 1.0)
        j = torch.remainder(torch.abs(i), period)
        return torch.where(j > n - 1, period - j, j)

    y = torch.arange(th, dtype=torch.float32, device=plane.device)[None, :]
    x = torch.arange(tw, dtype=torch.float32, device=plane.device)[None, :]
    acc = None
    for dy in range(-2, 3):
        rows = plane[bi[:, None], refl(y + dy, ph).long()]  # (B, th, tw, 3)
        acc = rows if acc is None else acc + rows
    acc2 = None
    for dx in range(-2, 3):
        ix = refl(x + dx, pw).long()  # (B, tw)
        cols = torch.gather(acc, 2, ix[:, None, :, None].expand(-1, th, -1, 3))
        acc2 = cols if acc2 is None else acc2 + cols
    blurred = torch.floor(acc2 / _const(acc2, 25.0) + 0.5)
    on = plan["blur_on"][:, None, None, None] > 0
    return torch.where(on, blurred, plane)


def _stage_b(plane, plan, out_hw, lb_fill):
    """Letterbox (nearest) of scale jitting (a bilinear crop) of the
    flips, as per-axis coordinate maps over the rendered plane: 2 row
    gathers and 2 column gathers. cv2.resize's INTER_LINEAR convention
    src = (dst + 0.5) / s - 0.5 with clamped edges."""
    b, th, tw, _ = plane.shape
    oh, ow = out_hw
    lbox, wh, flips = plan["lbox"], plan["plane_wh"], plan["flips"]
    scale = lbox[:, 0:1]
    jon = plan["jit_on"][:, None]
    jit = plan["jit"][:, None]
    jfl = plan["jit_flip"][:, None]

    def axis_coords(size, pad, n, joff, fl, mirror):
        """Output index -> (tap 0, tap 1, fraction, inside) in plane coords."""
        d = torch.arange(size, dtype=torch.float32, device=plane.device)[None, :]
        i = torch.floor((d - pad) / scale)  # letterbox's inverse, nearest
        valid = (i >= 0) & (i < n)
        i = torch.minimum(i.clamp_min(0), n - 1)
        # jitter's inverse: the crop offset, the mirror (horizontal only),
        # then the resize's source map at the true size ratio n / r
        r = torch.floor(n * jit)
        c = i + joff
        if mirror:
            c = torch.where(jfl > 0, r - 1.0 - c, c)
        u = torch.minimum(((c + 0.5) * (n / r) - 0.5).clamp_min(0), n - 1)
        u = torch.where(jon > 0, u, i)
        t0 = torch.floor(u)
        f = u - t0
        t1 = torch.minimum(t0 + 1.0, n - 1)
        # the plan's flips came before the jitter: mirror the taps last
        t0 = torch.where(fl > 0, n - 1 - t0, t0)
        t1 = torch.where(fl > 0, n - 1 - t1, t1)
        return t0.long(), t1.long(), f, valid

    y0, y1, fy, vy = axis_coords(oh, lbox[:, 2:3], wh[:, 1:2], plan["jit_off"][:, 1:2],
                                 flips[:, 1:2], False)  # (B, H)
    x0, x1, fx, vx = axis_coords(ow, lbox[:, 1:2], wh[:, 0:1], plan["jit_off"][:, 0:1],
                                 flips[:, 0:1], True)  # (B, W)
    bi = torch.arange(b, device=plane.device)[:, None]
    rows = (plane[bi, y0] * (1.0 - fy)[:, :, None, None]
            + plane[bi, y1] * fy[:, :, None, None])  # (B, H, tw, 3)

    def cols(idx):
        return torch.gather(rows, 2, idx[:, None, :, None].expand(-1, oh, -1, 3))

    val = cols(x0) * (1.0 - fx)[:, None, :, None] + cols(x1) * fx[:, None, :, None]
    val = torch.round(val)  # the host's resize gives uint8
    valid = vy[:, :, None] & vx[:, None, :]
    out = torch.where(valid[..., None], val, float(lb_fill))
    return torch.clamp(out, 0, 255).to(torch.uint8)


def _render_batch(tiles, plan, out_hw, tile_hw, fill, lb_fill, method, staged):
    """Pointwise (``staged`` off): per output pixel, the host chain in
    inverse: letterbox (each sample's scale and pads, nearest) of the flips
    of [cutout, HSV] of the warp of the mosaic gather and mixup blend;
    only output pixels are computed. Staged (blur or scale jitting): the
    plane is rendered at tile_hw first (warp, sample, cutout, HSV at
    identity coords), then ``_blur5``, then ``_stage_b``."""
    oh, ow = out_hw
    th, tw = tile_hw
    dev = tiles.device

    if staged:
        x = torch.arange(tw, dtype=torch.float32, device=dev)[None, None, :]
        y = torch.arange(th, dtype=torch.float32, device=dev)[None, :, None]
        val = _warp_and_sample(tiles, plan, x, y, th, tw, fill, method)
        val = _pointwise_chain(val, plan, x, y)
        val = _blur5(val, plan)
        return _stage_b(val, plan, out_hw, lb_fill)

    x = torch.arange(ow, dtype=torch.float32, device=dev)[None, None, :]
    y = torch.arange(oh, dtype=torch.float32, device=dev)[None, :, None]
    lbox, wh = plan["lbox"], plan["plane_wh"]
    scale = lbox[:, 0][:, None, None]
    padl = lbox[:, 1][:, None, None]
    padt = lbox[:, 2][:, None, None]
    pw = wh[:, 0][:, None, None]
    ph = wh[:, 1][:, None, None]

    # letterbox's inverse, nearest: floor(dst / scale); x per column, y per row
    xi = torch.floor((x - padl) / scale)  # (B, 1, W)
    yi = torch.floor((y - padt) / scale)  # (B, H, 1)
    valid = (xi >= 0) & (xi < pw) & (yi >= 0) & (yi < ph)
    xi = torch.minimum(xi.clamp_min(0), pw - 1)
    yi = torch.minimum(yi.clamp_min(0), ph - 1)

    flip_lr = plan["flips"][:, 0][:, None, None]
    flip_ud = plan["flips"][:, 1][:, None, None]
    fx = torch.where(flip_lr > 0, pw - 1 - xi, xi)
    fy = torch.where(flip_ud > 0, ph - 1 - yi, yi)

    val = _warp_and_sample(tiles, plan, fx, fy, th, tw, fill, method)
    val = _pointwise_chain(val, plan, fx, fy)
    out = torch.where(valid[..., None], val, float(lb_fill))
    return torch.clamp(out, 0, 255).to(torch.uint8)
