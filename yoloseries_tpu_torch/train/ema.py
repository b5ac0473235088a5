"""EMA of the whole model state (``state_dict``) as a lerp.

Counterpart of ``yoloseries_tpu/train/ema.py``: decay = ratio * (1 -
exp(-n / 2000)), computed in float32 from the update count n, applied to
every floating tensor of the ``state_dict`` (BN running stats included);
integer buffers (``num_batches_tracked``) are copied.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ema_decay_weight", "ema_update"]


def ema_decay_weight(update_num, decay_ratio: float = 0.9999) -> float:
    """The decay after ``update_num`` updates, computed in float32 (torch's
    f32 exp, correctly rounded where numpy's is an ulp off: 1 - exp(-n/2000)
    cancels at small n)."""
    n = torch.tensor(update_num, dtype=torch.float32)
    return float(decay_ratio * (1.0 - torch.exp(-n / 2000.0)))


@torch.no_grad()
def ema_update(ema: dict, new: dict, update_num, decay_ratio: float = 0.9999) -> None:
    """One EMA step in place: ``ema = d * ema + (1 - d) * new`` in each
    floating tensor, a copy of ``new`` in the others."""
    d = ema_decay_weight(update_num, decay_ratio)
    one_minus = float(np.float32(1.0) - np.float32(d))
    floats = [k for k, v in ema.items() if v.is_floating_point()]
    if floats:
        dst = [ema[k] for k in floats]
        torch._foreach_mul_(dst, d)
        torch._foreach_add_(dst, [new[k].to(ema[k].dtype) for k in floats], alpha=one_minus)
    for k, v in ema.items():
        if not v.is_floating_point():
            v.copy_(new[k])
