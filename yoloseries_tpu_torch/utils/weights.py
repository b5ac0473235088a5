"""JAX parameter trees -> the port's ``state_dict``.

The inverse of the JAX package's ``convert_yolov5_state_dict``: flax module
paths map to the reference's module names, conv kernels go from HWIO to
OIHW, and BatchNorm's scale/bias/mean/var become
weight/bias/running_mean/running_var. Inputs are nested dicts of numpy
arrays (for example from ``jax.device_get`` or an ``.npz``); no JAX is
needed.

Every YOLOv5 spec maps: the depthwise pair (``dw``/``pw``), the ``Focus``
stem (``stem/conv/...``), SPP's ``cv1``/``cv2`` and ``BottleneckCSP``'s raw
``cv_side``/``cv_mid`` convs and block-level ``bn``. The way back, JAX's
``convert_yolov5_state_dict``, passes unknown inner names through and so
reads the depthwise, Focus and SPP names of a port ``state_dict``; it cannot
read ``BottleneckCSP``'s raw convs or its block-level BN, so ``s_plain``
converts one way only, JAX to the port.

YOLOX and YOLOv8 map to the reference's names as well, so the JAX package's
``convert_yolox_state_dict`` and ``convert_yolov8_state_dict`` invert this
for them. YOLOX's DarkNet models have no reference converter: their
backbone and neck take the JAX module paths as names (see
``models/yolox.py``) and convert one way only, JAX to the port. The model
is told apart by the tree's top-level modules.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "state_dict_key", "flatten_tree", "unflatten_tree"]

_TRUNK = {
    "stem": "focus",
    "b1_conv": "backbone_stage1_conv",
    "b1_csp": "backbone_stage1_bscp",
    "b2_conv": "backbone_stage2_conv",
    "b2_csp": "backbone_stage2_bscp",
    "b3_conv": "backbone_stage3_conv",
    "b3_csp": "backbone_stage3_bscp",
    "b4_conv": "backbone_stage4_conv",
    "b4_csp": "backbone_stage4_bscp",
    "b4_spp": "backbone_stage4_spp",
    "h1_conv": "head_stage1_conv",
    "h1_csp": "head_stage1_bscp",
    "h2_conv": "head_stage2_conv",
    "h2_csp": "head_stage2_bscp",
    "h3_conv": "head_stage3_conv",
    "h3_csp": "head_stage3_bscp",
    "h4_conv": "head_stage4_conv",
    "h4_csp": "head_stage4_bscp",
}
_DETECT = {"detect_0": "detect_small", "detect_1": "detect_mid",
           "detect_2": "detect_large"}
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
# BottleneckCSP's raw 1x1 convs (the generic rule would make them cba*)
_RAW_CONV = {"cv_side": "side_conv", "cv_mid": "mid_conv"}
YOLOX_HEADS = ("pred_small", "pred_middle", "pred_large")
_V8_TRUNK = {
    "stem1": "backbone_stem1", "stem2": "backbone_stem2",
    "b1_c2f": "backbone_stage1_c2f", "b1_conv": "backbone_stage1_conv",
    "b2_c2f": "backbone_stage2_c2f", "b2_conv": "backbone_stage2_conv",
    "b3_c2f": "backbone_stage3_c2f", "b3_conv": "backbone_stage3_conv",
    "b4_c2f": "backbone_stage4_c2f", "b4_spp": "backbone_stage4_spp",
    "h1_c2f": "head_stage1_c2f1", "h2_c2f": "head_stage2_c2f1", "h3_c2f": "head_stage3_c2f1",
    "h3_conv": "head_stage3_conv", "h3_c2f2": "head_stage3_c2f2",
    "h2_conv": "head_stage2_conv", "h2_c2f2": "head_stage2_c2f2",
    "h1_conv": "head_stage1_conv", "h1_c2f2": "head_stage1_c2f2",
}
# C2f's and its blocks' convs conv1/conv2, FastSPP's cba1/cba2
_V8_CV = {"cv1": "conv1", "cv2": "conv2"}
_V8_SCALES = ("xsmall", "small", "mid", "large")
_V8_HEAD = {"box1": ("bbox", 0), "box2": ("bbox", 1), "box_out": ("bbox", 2),
            "cls1": ("cls", 0), "cls2": ("cls", 1), "cls_out": ("cls", 2)}


def flatten_tree(tree: dict, prefix=()) -> dict:
    """Nested dict -> {path tuple: leaf}."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten_tree(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def unflatten_tree(flat: dict) -> dict:
    """{path tuple: leaf} -> nested dict (inverse of ``flatten_tree``)."""
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def _v5_inner(names: list, inner, in_block: bool = False) -> str:
    """Flax names inside a YOLOv5 trunk module -> the reference's."""
    for part in inner:
        if part in _RAW_CONV:
            names.append(_RAW_CONV[part])
        elif part.startswith("block"):
            names.append(f"blocks.{part[len('block'):]}")
            in_block = True
        elif part.startswith("cv"):
            k = part[len("cv"):]
            names.append(f"conv_bn_act_{k}" if in_block else f"cba{k}")
        else:  # "conv" / "bn" inside ConvBnAct, "dw" / "pw", Focus's "conv"
            names.append(part)
    return ".".join(names)


def _yolox_head(index: int, inner, tower_depth: int) -> str:
    """``head{i}/...`` of YOLOX -> ``detect.pred_*...``: the towers are the
    first ``tower_depth`` entries of ``cls`` / ``conv``, the cls conv the
    last entry of ``cls``."""
    part, rest = inner[0], list(inner[1:])
    if part.startswith("cls_tower"):
        names = ["cls", part[len("cls_tower"):]]
    elif part.startswith("reg_tower"):
        names = ["conv", part[len("reg_tower"):]]
    elif part == "cls":
        names = ["cls", str(tower_depth)]
    else:  # stem, reg, cof
        names = [part]
    return ".".join(["detect", YOLOX_HEADS[index], *names, *rest])


def _v8_inner(inner) -> str:
    names = []
    for part in inner:
        if part.startswith("block"):
            names += ["block", part[len("block"):]]
        else:
            names.append(_V8_CV.get(part, part))
    return ".".join(names)


def _module_name(path: tuple, family: str = "yolov5", tower_depth: int = 1) -> str:
    """Flax module path (without the leaf) -> the port's module name."""
    top, *inner = path
    if family == "yolov8":
        if top.startswith("head"):
            branch, idx = _V8_HEAD[inner[0]]
            return f"detect.detect_{_V8_SCALES[int(top[4:])]}_{branch}.{idx}" + "".join(
                f".{p}" for p in inner[1:])
        if top == "b4_spp":  # FastSPP: cba1 / cba2
            return _v5_inner([_V8_TRUNK[top]], inner)
        return ".".join([_V8_TRUNK[top], *([_v8_inner(inner)] if inner else [])])
    if top.startswith("head") and family in ("yolox", "yolox_darknet"):
        return _yolox_head(int(top[4:]), inner, tower_depth)
    if family == "yolox_darknet":
        if top == "backbone":
            sub, *rest = inner
            return _v5_inner(["backbone", sub], rest, in_block="_b" in sub)
        return _v5_inner([top], inner)
    if top == "detect" and family == "yolov5":
        return f"detect.{_DETECT[inner[0]]}"
    if top != "trunk":
        raise KeyError(f"unmapped JAX module path: {'/'.join(path)}")
    sub, *rest = inner
    name = _v5_inner([_TRUNK[sub]], rest)
    return "neck." + name if family == "yolox" else name


def _family_of_tree(params: dict) -> str:
    """Which model a JAX parameter tree is: "yolov5", "yolox",
    "yolox_darknet" or "yolov8", by its top-level modules."""
    if "stem1" in params:
        return "yolov8"
    if "backbone" in params:
        return "yolox_darknet"
    return "yolox" if "head0" in params else "yolov5"


def state_dict_key(path: tuple, family: str = "yolov5", tower_depth: int = 1) -> str:
    """Flattened JAX path (params or batch_stats, leaf included) -> the
    port's ``state_dict`` key."""
    name, leaf = _module_name(path[:-1], family, tower_depth), path[-1]
    if leaf == "kernel":
        return f"{name}.weight"
    if path[-2] == "bn":
        return f"{name}.{_BN_LEAF[leaf]}"
    if leaf == "bias":  # a head conv's bias
        return f"{name}.bias"
    raise KeyError(f"unmapped JAX parameter: {'/'.join(path)}")


def state_dict_from_jax(params: dict, batch_stats: dict) -> dict:
    """(params, batch_stats) of a JAX ``YOLOv5``, ``YOLOX``,
    ``YOLOXDarknet`` or ``YOLOv8`` -> port ``state_dict`` (name -> float32
    tensor, plus ``num_batches_tracked`` per BatchNorm)."""
    family = _family_of_tree(params)
    depth = sum(k.startswith("cls_tower") for k in params.get("head0", {}))
    sd = {}
    for path, value in flatten_tree(params).items():
        value = np.asarray(value, dtype=np.float32)
        key = state_dict_key(path, family, depth)
        if path[-1] == "kernel":  # HWIO -> OIHW
            value = value.transpose(3, 2, 0, 1)
        elif path[-2] == "bn":
            sd[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.tensor(0)
        sd[key] = torch.from_numpy(value.copy())
    for path, value in flatten_tree(batch_stats).items():
        sd[state_dict_key(path, family, depth)] = torch.from_numpy(
            np.asarray(value, dtype=np.float32).copy())
    return sd
