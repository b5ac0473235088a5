"""What the reference model's forward does, counted on the meta device:
its FLOPs by ``torch.utils.flop_counter`` (convolutions and matmuls, 2 a
multiply-add), and the outputs of its conv + BN + SiLU blocks."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import models
from ..reference.families import family


def forward_flops(cfg: dict, size: int) -> int:
    """FLOPs of one image at ``size`` x ``size``."""
    sd, _ = models.build_state(cfg, "meta")
    with FlopCounterMode(display=False) as counter:
        models.forward(sd, torch.zeros(1, 3, size, size, device="meta"), cfg)
    return counter.get_total_flops()


def epilogue_elements(cfg: dict, batch: int, size: int) -> list[int]:
    """Elements of each conv + BN + SiLU block's BN output, in forward
    order, in one eval forward of ``batch`` images at ``size`` x ``size``."""
    sd, _ = models.build_state(cfg, "meta")
    net = models.Net(sd)
    family(cfg).forward(net, torch.zeros(batch, 3, size, size, device="meta"), cfg)
    return net.epilogues
