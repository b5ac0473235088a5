"""Auxiliary crop classifier; counterpart of ``yoloseries_tpu/models/classifier.py``.

The reference trains a ResNet-101 with a new fc layer on detection crops,
meant to re-score a detector's outputs; no family uses it. Here: the port's
ResNet bottleneck backbone (RetinaNet's), global average pooling and a
linear head ``fc``, with ``train_classifier``, a plain supervised loop
(Adam, softmax cross-entropy) over (crop, label) batches.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .retinanet import ResNetBackbone

__all__ = ["CropClassifier", "train_classifier"]


class CropClassifier(nn.Module):
    """NCHW crops -> (B, num_class) logits. ``fc``'s weight is drawn from
    N(0, 1 / fan_in), its bias zero (flax ``Dense``'s LeCun scale)."""

    def __init__(self, num_class: int, resnet_layers=(3, 4, 23, 3),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.backbone = ResNetBackbone(resnet_layers, generator=generator)
        width = self.backbone.out_channels[-1]
        self.fc = nn.Linear(width, num_class)
        with torch.no_grad():
            self.fc.weight.normal_(0.0, math.sqrt(1.0 / width), generator=generator)
            self.fc.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, c5 = self.backbone(x)
        return self.fc(c5.mean(dim=(2, 3)))


def train_classifier(model: CropClassifier, batches, lr: float = 1e-3, log_fn=print):
    """Train ``model`` in place: ``batches`` yield (images (B, H, W, 3)
    float, labels (B,) int) as numpy arrays, copied to the model's device.
    Returns the loss of each step as a list of floats (read once, at the
    end)."""
    dev = next(model.parameters()).device
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    model.train()
    losses = []
    for i, (imgs, labels) in enumerate(batches):
        x = torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).permute(0, 3, 1, 2).to(dev)
        y = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
        logits = model(x)
        loss = F.cross_entropy(logits, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if i % 10 == 0:
            acc = (logits.argmax(-1) == y).float().mean()
            log_fn(f"classifier step {i}: loss {float(loss.detach()):.4f} acc {float(acc):.3f}")
    model.eval()
    return torch.stack(losses).tolist() if losses else []
