"""Shared loss primitives: BCE on logits with a positive weight and the
focal factor, as in ``yoloseries_tpu/losses/common.py``.

Softplus is ``logaddexp(x, 0)``, the form of ``jax.nn.softplus``: finite at
any logit (a plain ``log(1 + exp(x))`` overflows past x = 88) and with the
gradient ``sigmoid(x)`` everywhere, x = 0 included.
"""

from __future__ import annotations

import torch

__all__ = ["bce_with_logits", "focal_loss_factor", "softplus"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, x.new_zeros(()))


def bce_with_logits(logits, targets, pos_weight=1.0):
    """Elementwise ``w * t * softplus(-x) + (1 - t) * softplus(x)``."""
    return pos_weight * targets * softplus(-logits) + (1.0 - targets) * softplus(logits)


def focal_loss_factor(logits, targets, gamma=1.5, alpha=0.25):
    """Focal modulation: ``(1 - acc) ** gamma`` times the alpha balance."""
    prob = torch.sigmoid(logits)
    acc = targets * prob + (1.0 - targets) * (1.0 - prob)
    gamma_factor = (1.0 - acc) ** gamma
    alpha_factor = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    return gamma_factor * alpha_factor
