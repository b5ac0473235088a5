"""Weights and inputs drawn from the run's seed, on the device.

Every conv weight comes from one ``torch.randn`` on a generator seeded with
the seed, scaled per conv to He's fan-out normal; BN starts at the identity.
Then, through the plain reference (``reference/models.py``), every BN takes
the statistics of a calibration batch as its running statistics, and each
output conv is scaled so that scores spread as a trained head's do
(``models.output_convs``). The one state dict goes to the program and to
the reference alike.
"""

from __future__ import annotations

import math

import torch

from ..reference import models

MASK64 = (1 << 64) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one use (``stream``) of the run's seed."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) & MASK64)


def images_u8(seed: int, stream: int, shape, device) -> torch.Tensor:
    """Uniform uint8 pixels (..., H, W, 3) on ``device``."""
    return torch.randint(0, 256, tuple(shape), generator=generator(seed, stream, device),
                         device=device, dtype=torch.uint8)


def to_input(u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) f32 in [0, 1]."""
    return u8.permute(0, 3, 1, 2).float().contiguous() / 255.0


@torch.no_grad()
def seeded_state(cfg: dict, seed: int, device, size: int, calib: int = 8) -> dict:
    sd, convs = models.build_state(cfg, device)
    weights = [sd[w] for w, _ in convs]
    flat = torch.randn(sum(w.numel() for w in weights), generator=generator(seed, 0, device),
                       device=device)
    off = 0
    for w in weights:
        n = w.numel()
        w.copy_(flat[off:off + n].view_as(w) * math.sqrt(2.0 / (w.shape[0] * w.shape[2]
                                                                 * w.shape[3])))
        off += n
    x = to_input(images_u8(seed, 1, (calib, size, size, 3), device))
    models.forward(sd, x, cfg, mode="calibrate")
    heads = models.output_convs(cfg)
    for _, b, *_ in heads:
        sd[b].zero_()
    maps = models.forward(sd, x, cfg)
    for w, b, sl, i, std, bias in heads:
        sd[w].mul_(std / maps[i][:, sl].std())
        sd[b].copy_(torch.as_tensor(bias, dtype=sd[b].dtype))
    return sd
