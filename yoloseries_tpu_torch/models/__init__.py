"""Model registry of the port: ``create_model`` for the nine YOLOv5 specs
(yolov5{s,m,l,x}, yolov5s_plain, yolov5{s,m,l,x}_dw) and for names added
with ``register``."""

from __future__ import annotations

from typing import Callable

import torch

from ..device import resolve_device
from .yolov5 import YOLOV5_SIZES, CSPTrunk, YOLOv5, YOLOv5Spec, space_to_depth2

__all__ = ["CSPTrunk", "YOLOV5_SIZES", "YOLOv5", "YOLOv5Spec",
           "available_models", "create_model", "register", "space_to_depth2"]

_REGISTRY: dict[str, Callable[..., torch.nn.Module]] = {}


def register(name: str):
    """Decorator: ``fn(num_class, generator=..., **kwargs) -> nn.Module``
    becomes buildable as ``create_model(name, ...)``."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def available_models() -> list[str]:
    return [f"yolov5{s}" for s in YOLOV5_SIZES] + sorted(_REGISTRY)


def create_model(name: str, num_class: int, device=None, seed: int = 0,
                 **kwargs) -> torch.nn.Module:
    """Build ``name`` with weights drawn from ``torch.Generator`` seeded with
    ``seed``, in eval mode, on ``device`` (default ``cuda``; raises without
    a card unless ``device="cpu"``). ``kwargs`` go to the model: for YOLOv5
    ``dtype``, ``remat``, ``s2d_stem``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if name in _REGISTRY:
        model = _REGISTRY[name](num_class=num_class, generator=gen, **kwargs)
    else:
        size = name.removeprefix("yolov5")
        if not name.startswith("yolov5") or size not in YOLOV5_SIZES:
            raise KeyError(f"unknown model '{name}'; available: {available_models()}")
        model = YOLOv5(num_class, YOLOV5_SIZES[size], generator=gen, **kwargs)
    return model.to(dev).eval()
