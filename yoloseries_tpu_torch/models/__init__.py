"""Model registry of the port: ``create_model`` for yolov5{s,m,l,x}."""

from __future__ import annotations

import torch

from ..device import resolve_device
from .yolov5 import YOLOV5_SIZES, CSPTrunk, YOLOv5, YOLOv5Spec

__all__ = ["CSPTrunk", "YOLOV5_SIZES", "YOLOv5", "YOLOv5Spec",
           "available_models", "create_model"]

_PORTED = ("s", "m", "l", "x")


def available_models() -> list[str]:
    return [f"yolov5{s}" for s in _PORTED]


def create_model(name: str, num_class: int, device=None, seed: int = 0,
                 **kwargs) -> YOLOv5:
    """Build ``name`` with weights drawn from ``torch.Generator`` seeded with
    ``seed``, in eval mode, on ``device`` (default ``cuda``; raises without
    a card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    size = name.removeprefix("yolov5")
    if not name.startswith("yolov5") or size not in YOLOV5_SIZES:
        raise KeyError(f"unknown model '{name}'; available: {available_models()}")
    gen = torch.Generator().manual_seed(seed)
    model = YOLOv5(num_class, YOLOV5_SIZES[size], generator=gen, **kwargs)
    return model.to(dev).eval()
