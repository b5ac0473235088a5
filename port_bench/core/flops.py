"""FLOPs of the reference model's forward, counted on the meta device by
``torch.utils.flop_counter`` (convolutions and matmuls, 2 a multiply-add)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import models


def forward_flops(cfg: dict, size: int) -> int:
    """FLOPs of one image at ``size`` x ``size``."""
    sd, _ = models.build_state(cfg, "meta")
    with FlopCounterMode(display=False) as counter:
        models.forward(sd, torch.zeros(1, 3, size, size, device="meta"), cfg)
    return counter.get_total_flops()
