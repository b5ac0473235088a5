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


def _module_name(path: tuple) -> str:
    """Flax module path (without the leaf) -> reference module name."""
    top, sub, *inner = path
    if top == "detect":
        return f"detect.{_DETECT[sub]}"
    if top != "trunk":
        raise KeyError(f"unmapped JAX module path: {'/'.join(path)}")
    names = [_TRUNK[sub]]
    in_block = False
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


def state_dict_key(path: tuple) -> str:
    """Flattened JAX path (params or batch_stats, leaf included) -> the
    port's ``state_dict`` key."""
    name, leaf = _module_name(path[:-1]), path[-1]
    if leaf == "kernel":
        return f"{name}.weight"
    if path[-2] == "bn":
        return f"{name}.{_BN_LEAF[leaf]}"
    if leaf == "bias":  # detect conv bias
        return f"{name}.bias"
    raise KeyError(f"unmapped JAX parameter: {'/'.join(path)}")


def state_dict_from_jax(params: dict, batch_stats: dict) -> dict:
    """(params, batch_stats) of the JAX ``YOLOv5`` -> port ``state_dict``
    (name -> float32 tensor, plus ``num_batches_tracked`` per BatchNorm)."""
    sd = {}
    for path, value in flatten_tree(params).items():
        value = np.asarray(value, dtype=np.float32)
        key = state_dict_key(path)
        if path[-1] == "kernel":  # HWIO -> OIHW
            value = value.transpose(3, 2, 0, 1)
        elif path[-2] == "bn":
            sd[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.tensor(0)
        sd[key] = torch.from_numpy(value.copy())
    for path, value in flatten_tree(batch_stats).items():
        sd[state_dict_key(path)] = torch.from_numpy(np.asarray(value, dtype=np.float32).copy())
    return sd
