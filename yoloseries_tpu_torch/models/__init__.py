"""Model registry of the port: ``create_model`` for the nine YOLOv5 specs
(yolov5{s,m,l,x}, yolov5s_plain, yolov5{s,m,l,x}_dw), the YOLOX family
(yolox_{s,m,l}, yolox_darknet{21,53}), the YOLOv8 family (yolov8 at the
reference's scale 0.5, yolov8{n,s,m}), yolov7, retinanet,
retinanet_experiment, fcos, fcos_cspnet and names added with ``register``:
every name the JAX package's registry builds."""

from __future__ import annotations

from typing import Callable

import torch

from ..device import resolve_device
from .fcos import FCOS, FCOSCSPNet
from .retinanet import ResNetBackbone, RetinaNet
from .yolov5 import YOLOV5_SIZES, CSPTrunk, YOLOv5, YOLOv5Spec, space_to_depth2
from .yolov7 import YOLOv7
from .yolov8 import YOLOv8
from .yolox import YOLOX, YOLOX_SIZES, YOLOXDarknet, YOLOXSpec

__all__ = ["CSPTrunk", "FCOS", "FCOSCSPNet", "ResNetBackbone", "RetinaNet", "YOLOV5_SIZES",
           "YOLOX", "YOLOXDarknet", "YOLOXSpec", "YOLOX_SIZES", "YOLOv5", "YOLOv5Spec",
           "YOLOv7", "YOLOv8", "available_models", "create_model", "register",
           "space_to_depth2"]

_REGISTRY: dict[str, Callable[..., torch.nn.Module]] = {}
_KNOBS: dict[str, tuple] = {}  # name -> the model knobs it takes
_ALL_KNOBS = ("dtype", "remat", "s2d_stem", "deploy")
_V5_KNOBS = ("dtype", "remat", "s2d_stem")


def register(name: str, knobs: tuple = _V5_KNOBS):
    """Decorator: ``fn(num_class, generator=..., **kwargs) -> nn.Module``
    becomes buildable as ``create_model(name, ...)``; ``knobs`` are those of
    ``dtype``, ``remat``, ``s2d_stem`` and ``deploy`` that it takes."""
    def deco(fn):
        _REGISTRY[name] = fn
        _KNOBS[name] = tuple(knobs)
        return fn

    return deco


def available_models() -> list[str]:
    return [f"yolov5{s}" for s in YOLOV5_SIZES] + sorted(_REGISTRY)


def create_model(name: str, num_class: int, device=None, seed: int = 0,
                 **kwargs) -> torch.nn.Module:
    """Build ``name`` with weights drawn from ``torch.Generator`` seeded with
    ``seed``, in eval mode, on ``device`` (default ``cuda``; raises without
    a card unless ``device="cpu"``). ``kwargs`` go to the model: ``dtype``
    for every family, ``remat`` for all but YOLOX on DarkNet, ``s2d_stem``
    for YOLOv5 and YOLOX on the CSP trunk, ``deploy`` for YOLOv7;
    ``resnet_layers`` for RetinaNet and FCOS. A knob the model lacks raises
    ``ValueError``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    size = name.removeprefix("yolov5")
    knobs = _KNOBS.get(name, _V5_KNOBS)
    missing = sorted(k for k in kwargs if k in _ALL_KNOBS and k not in knobs)
    if missing:
        raise ValueError(f"model {name!r} has no {', '.join(missing)} knob "
                         f"(it takes {', '.join(knobs) or 'none'})")
    if name in _REGISTRY:
        model = _REGISTRY[name](num_class=num_class, generator=gen, **kwargs)
    else:
        if not name.startswith("yolov5") or size not in YOLOV5_SIZES:
            raise KeyError(f"unknown model '{name}'; available: {available_models()}")
        model = YOLOv5(num_class, YOLOV5_SIZES[size], generator=gen, **kwargs)
    return model.to(dev).eval()


def _register_families():
    for size, spec in YOLOX_SIZES.items():
        register(f"yolox_{size}")(lambda num_class, _spec=spec, **kw: YOLOX(num_class, _spec, **kw))
    for name, blocks in (("yolox_darknet53", (1, 2, 8, 8, 4)),
                         ("yolox_darknet21", (1, 1, 2, 2, 1))):
        register(name, knobs=("dtype",))(
            lambda num_class, _b=blocks, **kw: YOLOXDarknet(num_class, _b, **kw))
    v8_knobs = ("dtype", "remat")
    register("yolov8", knobs=v8_knobs)(lambda num_class, **kw: YOLOv8(num_class, **kw))
    for name, scale in (("yolov8n", 0.34), ("yolov8s", 0.5), ("yolov8m", 1.0)):
        register(name, knobs=v8_knobs)(
            lambda num_class, _s=scale, **kw: YOLOv8(num_class, _s, **kw))
    register("yolov7", knobs=("dtype", "remat", "deploy"))(
        lambda num_class, **kw: YOLOv7(num_class, **kw))
    register("retinanet", knobs=v8_knobs)(lambda num_class, **kw: RetinaNet(num_class, **kw))
    register("retinanet_experiment", knobs=v8_knobs)(
        lambda num_class, **kw: RetinaNet(num_class, with_objectness=True, **kw))
    register("fcos", knobs=v8_knobs)(lambda num_class, **kw: FCOS(num_class, **kw))
    register("fcos_cspnet", knobs=v8_knobs)(lambda num_class, **kw: FCOSCSPNet(num_class, **kw))


_register_families()
