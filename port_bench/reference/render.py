"""The render of augmentation plans on the card: a frozen copy of the port's
``data/device_aug.py`` render (its pointwise path with the general
per-pixel gather, which a warp with perspective takes), and the image
cache it reads, worked out again from the image files.

The plans (which images, tiles, warp, mixup ratio, cutout, HSV gains,
flips and letterbox of each sample) are the program's planner's, read
from the batches its loader handed over; the render of them is checked
here byte for byte. Per output pixel: the letterbox's inverse (nearest),
the flips, the warp's inverse, the 1/32 quantized canvas position, four
bilinear taps from the mosaic tiles of both mixup layers (uncovered canvas
reads the fill), the blend, cutout's paint and the HSV jitter in cv2's
uint8 convention.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

N_TILES = 8
N_CUTOUT = 31


def cache_from_files(img_dir, size: int, device) -> torch.Tensor:
    """(N, size, size, 3) uint8: each image of the sorted file list at the
    top left of a zero canvas (every image of the set fits at scale 1)."""
    from PIL import Image

    files = sorted(p for p in Path(img_dir).iterdir() if p.suffix.lower() == ".jpg")
    cache = np.zeros((len(files), size, size, 3), np.uint8)
    for i, f in enumerate(files):
        img = np.asarray(Image.open(f).convert("RGB"))
        h, w = img.shape[:2]
        if max(h, w) > size:
            raise ValueError(f"{f.name}: {h}x{w} does not fit {size} at scale 1")
        cache[i, :h, :w] = img
    return torch.from_numpy(cache).to(device)


@torch.no_grad()
def render(cache, plan, out_hw, tile_hw, fill=114, lb_fill=114):
    """(B, H, W, 3) uint8 of the batched plan fields (tensors on the cache's
    device) against the image cache."""
    tiles = repack_tiles(cache, plan["img_ids"], plan["tile_off"])
    oh, ow = out_hw
    th, tw = tile_hw
    dev = tiles.device
    x = torch.arange(ow, dtype=torch.float32, device=dev)[None, None, :]
    y = torch.arange(oh, dtype=torch.float32, device=dev)[None, :, None]
    lbox, wh = plan["lbox"], plan["plane_wh"]
    scale = lbox[:, 0][:, None, None]
    padl = lbox[:, 1][:, None, None]
    padt = lbox[:, 2][:, None, None]
    pw = wh[:, 0][:, None, None]
    ph = wh[:, 1][:, None, None]
    xi = torch.floor((x - padl) / scale)
    yi = torch.floor((y - padt) / scale)
    valid = (xi >= 0) & (xi < pw) & (yi >= 0) & (yi < ph)
    xi = torch.minimum(xi.clamp_min(0), pw - 1)
    yi = torch.minimum(yi.clamp_min(0), ph - 1)
    flip_lr = plan["flips"][:, 0][:, None, None]
    flip_ud = plan["flips"][:, 1][:, None, None]
    fx = torch.where(flip_lr > 0, pw - 1 - xi, xi)
    fy = torch.where(flip_ud > 0, ph - 1 - yi, yi)

    minv, rects = plan["minv"], plan["rects"]
    m = [[minv[:, r, c][:, None, None] for c in range(3)] for r in range(3)]
    u = m[0][0] * fx + m[0][1] * fy + m[0][2]
    v = m[1][0] * fx + m[1][1] * fy + m[1][2]
    w_ = m[2][0] * fx + m[2][1] * fy + m[2][2]
    u = u / w_
    v = v / w_
    b = tiles.shape[0]
    tiles_px = tiles.reshape(-1, 3)
    first = torch.arange(b, device=dev).reshape(b, 1, 1) * (N_TILES * th * tw)
    layers = [_sample_layer(tiles_px, first + 4 * i * th * tw, rects[:, 4 * i:4 * i + 4],
                            u, v, th, tw, float(fill)) for i in (0, 1)]
    ratio = plan["mix"][:, None, None, None]
    val = torch.round(ratio * layers[0] + (1.0 - ratio) * layers[1])
    val = _pointwise_chain(val, plan, fx, fy)
    out = torch.where(valid[..., None], val, float(lb_fill))
    return torch.clamp(out, 0, 255).to(torch.uint8)


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
