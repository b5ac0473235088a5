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

YOLOX, YOLOv8, YOLOv7, RetinaNet and FCOS map to the reference's names as
well, so the JAX package's ``convert_yolox_state_dict``,
``convert_yolov8_state_dict``, ``convert_yolov7_state_dict``,
``convert_retinanet_state_dict`` and ``convert_fcos_state_dict`` invert this
for them: YOLOv7's flat ELAN convs, RepConv's ``rbr_*`` branches (and the
deploy form's ``rbr_reparam``) and the implicit priors (``implicit``, (1, C,
1, 1) here, (1, 1, 1, C) there); the ResNets' torchvision names; FCOS's
GroupNorm ``scale``/``bias`` (the reference names them ``bn``) and its
``Scale`` scalars. YOLOX's DarkNet models and FCOS on the CSP trunk have no
reference converter: DarkNet's backbone and neck take the JAX module paths
as names (see ``models/yolox.py``), FCOS-CSPNet's trunk YOLOv5's names
under ``trunk.``, and they convert one way only, JAX to the port. The crop
classifier (``models/classifier.py``) maps its ResNet as RetinaNet's and its
``Dense`` head to ``fc`` (the kernel transposed). The model is told apart by
the tree's top-level modules; a single block (``ELANBlock``,
``SEBottleneckCSP``, ...) is converted with ``family="block"``: the YOLOv5
trunk's names inside a block, ``se.fc`` for the SE gate.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "state_dict_key", "flatten_tree", "unflatten_tree",
           "jax_tree_layout", "param_from_jax", "read_torch_blob", "strip_ddp_prefix",
           "load_blob_weights"]

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
# flax leaf -> torch leaf; a kernel is also transposed HWIO -> OIHW and an
# implicit prior (1, 1, 1, C) -> (1, C, 1, 1)
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var", "implicit": "implicit"}
_ELAN = ("cv1", "cv2", "cv3", "cv4", "cv5", "cv6", "cv_out")
_DOWN = ("mp_cv", "cv1", "cv2")
_V7_SCALES = ("s", "m", "l")
_REP = {"rbr_dense_conv": "rbr_dense.0", "rbr_dense_bn": "rbr_dense.1",
        "rbr_1x1_conv": "rbr_1x1.0", "rbr_1x1_bn": "rbr_1x1.1",
        "rbr_identity_bn": "rbr_identity", "rbr_reparam": "rbr_reparam"}
_RESNET = {"stem_conv": "conv1", "stem_bn": "bn1", "stem_gn": "bn1"}
_BLOCK = {"down_conv": "downsample.0", "down_bn": "downsample.1", "down_gn": "downsample.1",
          "gn1": "bn1", "gn2": "bn2", "gn3": "bn3"}
_FCOS_OUT = {"cls_out": "cls_out_layer", "reg_out": "reg_out_layer", "ctr_out": "ctr_out_layer"}


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


def _v7_name(top: str, inner) -> str:
    """A YOLOv7 module path -> its flat reference name."""
    if top.startswith(("ia_", "im_", "detect_")):
        kind = {"ia": "implicitadd", "im": "implicitmul", "detect": "detect"}[top.rsplit("_", 1)[0]]
        return f"detect.{kind}_{_V7_SCALES[int(top[-1])]}"
    if top.startswith("rep_"):
        i = "sml".index(top[-1]) + 1
        return ".".join([f"head.head_output_repconv{i}", *(_REP[p] for p in inner)])
    if top == "spp":
        return ".".join(["head.head_spp", inner[0].replace("cv", "cba"), *inner[1:]])
    if top == "stem":
        return ".".join(["backbone.stem", *inner])
    rest = inner
    if top.startswith("b"):  # b{s}_cv{n}, b{s}_down, b{s}_elan
        stage, part = int(top[1]), top[3:]
        prefix = f"backbone.backbone_stage{stage}_conv"
        if stage == 1:
            n = int(part[len("cv"):])
        elif stage == 2:
            n = 1 if part == "down" else 2 + _ELAN.index(inner[0])
        else:
            n = (1 + _DOWN.index(inner[0])) if part == "down" else 4 + _ELAN.index(inner[0])
        rest = inner if stage == 1 or (stage == 2 and part == "down") else inner[1:]
    else:  # h{i}_lat, h{i}_route, h{i}_down, h{i}_elan
        i, part = int(top[1]), top[3:]
        prefix = f"head.head_eelan{i}_conv"
        if part in ("lat", "route"):
            n, rest = (1 if part == "lat" else 2), inner
        elif part == "down":
            n, rest = 1 + _DOWN.index(inner[0]), inner[1:]
        else:
            n, rest = (3 if i <= 2 else 4) + _ELAN.index(inner[0]), inner[1:]
    return ".".join([f"{prefix}{n}", *rest])


def _resnet_name(top: str, inner) -> str:
    """``backbone`` of RetinaNet or FCOS -> torchvision's names."""
    sub, *rest = inner
    if sub in _RESNET:
        return f"{top}.{_RESNET[sub]}"
    layer, block = sub.split("_")
    return ".".join([top, layer, block, *(_BLOCK.get(p, p) for p in rest)])


def _fcos_head_name(inner) -> str:
    sub = inner[0]
    if sub in _FCOS_OUT:
        return f"head.{_FCOS_OUT[sub]}"
    if sub.startswith("scale"):
        return f"head.scales.{sub[len('scale'):]}"
    kind, idx = sub[:3], sub[-1]  # cls_conv{i} / cls_gn{i} / reg_...
    return f"head.{kind}_layers.{idx}.{0 if 'conv' in sub else 1}"


def _module_name(path: tuple, family: str = "yolov5", tower_depth: int = 1) -> str:
    """Flax module path (without the leaf) -> the port's module name."""
    top, *inner = path
    if family == "block":
        return _v5_inner([], path)
    if family == "classifier":
        return "fc" if top == "fc" else _resnet_name(top, inner)
    if family == "yolov7":
        return _v7_name(top, inner)
    if family in ("retinanet", "fcos", "fcos_cspnet"):
        if top == "backbone":
            return _resnet_name(top, inner)
        if top == "fpn":
            return f"fpn.{inner[0]}"
        if top in ("regression", "classification"):
            return f"{top}.{'output' if inner[0] == 'out' else inner[0]}"
        if top == "head":
            return _fcos_head_name(inner)
        if top.startswith("lat"):
            return top
        if top == "trunk":
            sub, *rest = inner
            return "trunk." + _v5_inner([_TRUNK[sub]], rest)
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
    "yolox_darknet", "yolov8", "yolov7", "retinanet", "fcos" or
    "fcos_cspnet", by its top-level modules."""
    if "stem1" in params:
        return "yolov8"
    if "fc" in params and "backbone" in params:
        return "classifier"
    if "rep_s" in params:
        return "yolov7"
    if "classification" in params:
        return "retinanet"
    if "head" in params and "fpn" in params:
        return "fcos"
    if "lat0" in params:
        return "fcos_cspnet"
    if "backbone" in params:
        return "yolox_darknet"
    return "yolox" if "head0" in params else "yolov5"


def state_dict_key(path: tuple, family: str = "yolov5", tower_depth: int = 1) -> str:
    """Flattened JAX path (params or batch_stats, leaf included) -> the
    port's ``state_dict`` key."""
    name, leaf = _module_name(path[:-1], family, tower_depth), path[-1]
    if leaf == "scale" and name.startswith("head.scales."):  # FCOS's Scale
        return f"{name}.scale"
    if leaf not in _LEAF:
        raise KeyError(f"unmapped JAX parameter: {'/'.join(path)}")
    return f"{name}.{_LEAF[leaf]}"


def jax_tree_layout(params: dict, family: str | None = None) -> tuple:
    """(family, FCOS/YOLOX tower depth) of a JAX parameter tree: what
    ``state_dict_key`` needs besides a path."""
    family = family or _family_of_tree(params)
    return family, sum(k.startswith("cls_tower") for k in params.get("head0", {}))


def param_from_jax(path: tuple, value) -> torch.Tensor:
    """One JAX parameter leaf (or a slot of the optimizer state shaped like
    it) in the port's layout: conv kernels HWIO -> OIHW, a Dense kernel
    transposed, an implicit prior (1, 1, 1, C) -> (1, C, 1, 1)."""
    value = np.asarray(value, dtype=np.float32)
    if path[-1] == "kernel" and value.ndim == 4:
        value = value.transpose(3, 2, 0, 1)
    elif path[-1] == "kernel":
        value = value.T
    elif path[-1] == "implicit":
        value = value.transpose(0, 3, 1, 2)
    return torch.from_numpy(value.copy())


def state_dict_from_jax(params: dict, batch_stats: dict, family: str | None = None) -> dict:
    """(params, batch_stats) of a JAX ``YOLOv5``, ``YOLOX``,
    ``YOLOXDarknet``, ``YOLOv8``, ``YOLOv7``, ``RetinaNet``, ``FCOS``,
    ``FCOSCSPNet`` or ``CropClassifier`` (or of one block, with
    ``family="block"``) -> port ``state_dict`` (name -> float32 tensor, plus
    ``num_batches_tracked`` per BatchNorm)."""
    family, depth = jax_tree_layout(params, family)
    sd = {}
    for path, value in flatten_tree(params).items():
        sd[state_dict_key(path, family, depth)] = param_from_jax(path, value)
    for path, value in flatten_tree(batch_stats).items():
        key = state_dict_key(path, family, depth)
        sd[key] = torch.from_numpy(np.asarray(value, dtype=np.float32).copy())
        sd[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.tensor(0)
    return sd


def strip_ddp_prefix(state_dict: dict) -> dict:
    """Drop the ``module.`` prefix that DistributedDataParallel adds."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def read_torch_blob(path) -> dict:
    """A reference ``.pth``: the ``Training.save_model`` dict
    (``model_state_dict``, ``ema``, ``hyp``, ``step``) or a bare
    ``state_dict``. Returns {raw, ema (None when the blob has none), hyp,
    step} with the ``module.`` prefixes stripped. The port's modules carry
    the reference's ``state_dict`` names, so ``raw`` and ``ema`` load into a
    port model as they are. Loaded with ``weights_only=True``: a blob of
    tensors, numbers, strings and containers."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        raw, ema = blob["model_state_dict"], blob.get("ema")
        hyp, step = dict(blob.get("hyp") or {}), int(blob.get("step") or 0)
    else:
        raw, ema, hyp, step = blob, None, {}, 0
    return {"raw": strip_ddp_prefix(raw), "ema": None if ema is None else strip_ddp_prefix(ema),
            "hyp": hyp, "step": step}


def load_blob_weights(model: torch.nn.Module, path, params: str = "ema") -> None:
    """Load weights from a file into ``model`` (strictly): an ``.npz`` of
    the JAX package's trees (``params/...`` and ``batch_stats/...`` paths
    joined by ``/``), or a ``.pt``/``.pth`` blob of ``read_torch_blob``,
    its EMA weights (``params="ema"``, the raw ones when it has no EMA) or
    its raw ones (``"raw"``). A 6x6 stem kernel is mapped to a model built
    with ``s2d_stem=True``."""
    from pathlib import Path

    from ..nn.deploy import fold_stem_to_s2d

    if params not in ("ema", "raw"):
        raise ValueError(f"params {params!r}: 'ema' or 'raw'")
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as data:
            tree = unflatten_tree({tuple(k.split("/")): data[k] for k in data.files})
        sd = state_dict_from_jax(tree["params"], tree.get("batch_stats", {}))
    else:
        blob = read_torch_blob(path)
        sd = blob["ema"] if params == "ema" and blob["ema"] is not None else blob["raw"]
    if any(getattr(m, "s2d_stem", False) for m in model.modules()):
        sd = fold_stem_to_s2d(sd)
    model.load_state_dict(sd)
