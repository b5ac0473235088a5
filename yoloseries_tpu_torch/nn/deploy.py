"""Deploy-time folds: conv+BN fusion, RepConv's reparameterization and the
space-to-depth stem.

Counterpart of ``yoloseries_tpu/nn/deploy.py`` (``fold_conv_bn``, the s2d
stem maps). The JAX package folds parameter trees and keeps each BN as
"+bias" (scale 1, mean 0, var 1 - eps); here ``fold_conv_bn`` is the
PyTorch idiom: every ``ConvBnAct``'s BN goes into its conv's weight and a
new conv bias, and the BN module becomes ``nn.Identity``, so the BN pass is
gone from the forward. Both compute the same function. ``BottleneckCSP``'s
BN over the concat has no conv directly before it and stays, as in JAX.
The heads' biased 1x1 convs (YOLOv5's detect convs, YOLOX's cls/reg/cof,
YOLOv8's box and cls outputs) have no BN and are left as they are, and so
are the BNs that no ``ConvBnAct`` wraps: RetinaNet's ResNet and RepConv's
branches, as the JAX fold leaves every BN that is not a ``bn`` beside a
``conv``. FCOS's GroupNorms hold no running statistics and stay.

``fold_repconv`` (after ``fold_conv_bn``, as the JAX package's detect
runs them) turns every training-form ``RepConv`` into its deploy form: the
three branches' BNs folded as above (``_fold_one`` of the JAX package), the
1x1 kernel padded to the centre tap, the identity BN folded over an
identity kernel, summed into one biased conv ``rbr_reparam``.

The stem maps work on ``state_dict``s (YOLOv5's, or YOLOX's with the same
trunk under ``neck.``) and the OIHW kernel layout: the 6x6/2 stem conv over
an image equals a 3x3/1 conv (padding 1) over
``models.yolov5.space_to_depth2`` of it, with
``W3[o, (2*dy + dx) * C + c, ky, kx] = W6[o, c, 2*ky + dy, 2*kx + dx]``.
"""

from __future__ import annotations

import torch
from torch import nn

import torch.nn.functional as F

from .layers import BatchNorm, ConvBnAct, RepConv

__all__ = [
    "fold_conv_bn",
    "fold_repconv",
    "fold_stem_from_s2d",
    "fold_stem_to_s2d",
    "stem_kernel_from_s2d",
    "stem_kernel_to_s2d",
]

STEM_KEY = "focus.conv.weight"  # the 6x6 (or s2d 3x3) stem conv of YOLOv5


@torch.no_grad()
def fold_conv_bn(model: nn.Module) -> nn.Module:
    """Fold the eval-mode BN of every ``ConvBnAct`` of ``model`` into its
    conv, in place: ``weight * (gamma / sqrt(var + eps))`` and bias
    ``beta - mean * gamma / sqrt(var + eps)`` (the JAX ``_fold_one``
    arithmetic). Returns ``model``, to be used in eval mode only."""
    for module in model.modules():
        if not isinstance(module, ConvBnAct) or not isinstance(module.bn, BatchNorm):
            continue
        bn, conv = module.bn, module.conv
        factor = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        conv.weight.mul_(factor[:, None, None, None])
        conv.bias = nn.Parameter(bn.bias - bn.running_mean * factor)
        module.bn = nn.Identity()
    return model


def _fold_one(weight, bn):
    """(OIHW kernel, eval-mode BN) -> the folded (kernel, bias)."""
    factor = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return weight * factor[:, None, None, None], bn.bias - bn.running_mean * factor


@torch.no_grad()
def fold_repconv(model: nn.Module) -> nn.Module:
    """Replace every training-form ``RepConv`` of ``model`` by its deploy
    form (``deploy=True``) carrying the folded ``rbr_reparam`` weight and
    bias, in place; a model that has one gets ``deploy = True`` too, so its
    ``state_dict`` is that of the model built with ``deploy=True``. Returns
    ``model``, to be used in eval mode only."""
    for parent in list(model.modules()):
        for name, rep in list(parent.named_children()):
            if not isinstance(rep, RepConv) or rep.deploy:
                continue
            dense, one = rep.rbr_dense[0], rep.rbr_1x1[0]
            k3, b3 = _fold_one(dense.weight, rep.rbr_dense[1])
            k1, b1 = _fold_one(one.weight, rep.rbr_1x1[1])
            pad = dense.kernel_size[0] // 2
            kernel, bias = k3 + F.pad(k1, (pad, pad, pad, pad)), b3 + b1
            if rep.rbr_identity is not None:
                ident = torch.zeros_like(kernel)
                per_group = kernel.shape[1]
                for c in range(kernel.shape[0]):
                    ident[c, c % per_group, pad, pad] = 1.0
                ki, bi = _fold_one(ident, rep.rbr_identity)
                kernel, bias = kernel + ki, bias + bi
            new = RepConv(dense.in_channels, dense.out_channels, dense.kernel_size[0],
                          dense.stride[0], dense.groups, act=rep.act, deploy=True)
            new.rbr_reparam.weight.copy_(kernel)
            new.rbr_reparam.bias.copy_(bias)
            setattr(parent, name, new.to(kernel.device).train(rep.training))
            model.deploy = True
    return model


def stem_kernel_to_s2d(k6: torch.Tensor) -> torch.Tensor:
    """(O, C, 6, 6) stem kernel -> the (O, 4C, 3, 3) kernel over the
    space-to-depth input. Exact, borders included: output row y of the
    6x6/2 conv (padding 2) reads rows 2y + ky - 2; with ky = 2*ky' + dy
    that is row y + ky' - 1 of the s2d map at offset dy."""
    o, c, kh, kw = k6.shape
    if (kh, kw) != (6, 6):
        raise ValueError(f"expected a 6x6 stem kernel, got {(kh, kw)}")
    k = k6.reshape(o, c, 3, 2, 3, 2).permute(0, 3, 5, 1, 2, 4)  # (o, dy, dx, c, ky', kx')
    return k.reshape(o, 4 * c, 3, 3).contiguous()


def stem_kernel_from_s2d(k3: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`stem_kernel_to_s2d`."""
    o, c4, kh, kw = k3.shape
    if (kh, kw) != (3, 3) or c4 % 4:
        raise ValueError(f"expected a 3x3 s2d stem kernel, got {tuple(k3.shape)}")
    k = k3.reshape(o, 2, 2, c4 // 4, 3, 3).permute(0, 3, 4, 1, 5, 2)  # (o, c, ky', dy, kx', dx)
    return k.reshape(o, c4 // 4, 6, 6).contiguous()


def fold_stem_to_s2d(state_dict: dict) -> dict:
    """A ``state_dict`` of the 6x6-stem model -> one for the same model built
    with ``s2d_stem=True``: only the stem kernel changes."""
    return _map_stem(state_dict, stem_kernel_to_s2d, want_kh=6)


def fold_stem_from_s2d(state_dict: dict) -> dict:
    """Inverse of :func:`fold_stem_to_s2d`."""
    return _map_stem(state_dict, stem_kernel_from_s2d, want_kh=3)


def _map_stem(state_dict, fn, want_kh):
    out = dict(state_dict)
    for key in (STEM_KEY, "neck." + STEM_KEY):  # YOLOv5; YOLOX's trunk under neck.
        k = out.get(key)
        if k is not None and k.dim() == 4 and k.shape[2] == want_kh:
            out[key] = fn(k)
    return out
