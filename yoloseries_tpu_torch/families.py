"""Detector-family adapters: model name -> loss, decode and candidate
selection; counterpart of ``yoloseries_tpu/families.py``.

* ``make_loss(hyp, num_class, input_size)`` -> (loss_fn, initial balances),
  ``loss_fn(preds, targets, balances) -> (loss_dict, new_balances)``, the
  interface of ``train.make_train_step``;
* ``make_decode(hyp, num_class, input_size)`` -> dense decode of the raw
  maps to (B, N, 5+nc) pixels;
* ``make_select(hyp, num_class, input_size)`` -> (eval_cfg -> fused
  candidate selection);
* ``apply_eval_overrides(eval_cfg, hyp)``: the family's postprocess quirks.

The yolov5, yolox and yolov8 families are ported; the others (yolov7,
retinanet, fcos) are ROADMAP A9 and ``get_family`` raises for them. Neither
yolox nor yolov8 overrides an ``EvalConfig`` field, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .losses.yolov5 import YOLOv5LossConfig, initial_balances, yolov5_loss
from .losses.yolov8 import YOLOv8LossConfig, yolov8_loss
from .losses.yolox import YOLOXLossConfig, yolox_initial_balances, yolox_loss
from .ops.anchors import YOLOV5_ANCHORS

__all__ = ["Family", "get_family", "family_of"]

_NOT_PORTED = ("yolov7", "fcos", "retinanet", "retinanet_experiment")


@dataclasses.dataclass(frozen=True)
class Family:
    name: str
    make_loss: Callable
    make_decode: Callable
    make_select: Callable | None = None
    eval_overrides: Callable | None = None  # (hyp) -> dict of EvalConfig fields

    def apply_eval_overrides(self, eval_cfg, hyp=None):
        if self.eval_overrides is None:
            return eval_cfg
        return dataclasses.replace(eval_cfg, **self.eval_overrides(hyp or {}))


def _yolov5_family() -> Family:
    def make_loss(hyp, num_class, input_size):
        cfg = YOLOv5LossConfig(
            num_class=num_class,
            input_size=tuple(input_size),
            anchor_match_thr=hyp.get("anchor_match_thr", 4.0),
            iou_loss_scale=hyp.get("iou_loss_scale", 0.05),
            cls_loss_scale=hyp.get("cls_loss_scale", 0.5),
            cof_loss_scale=hyp.get("cof_loss_scale", 1.0),
            cls_pos_weight=hyp.get("cls_pos_weight", 1.0),
            cof_pos_weight=hyp.get("cof_pos_weight", 1.0),
            class_smooth_factor=hyp.get("class_smooth_factor", 1.0),
            use_focal_loss=hyp.get("use_focal_loss", True),
            focal_loss_gamma=hyp.get("focal_loss_gamma", 1.5),
            focal_loss_alpha=hyp.get("focal_loss_alpha", 0.25),
        )

        def loss_fn(preds, targets, balances):
            return yolov5_loss(preds, targets, YOLOV5_ANCHORS, balances, cfg)

        return loss_fn, initial_balances()

    def make_decode(hyp, num_class, input_size):
        from .evaluation.yolov5 import yolov5_decode_fn

        return yolov5_decode_fn()

    def make_select(hyp, num_class, input_size):
        from .evaluation.yolov5 import yolov5_select_fn

        return yolov5_select_fn

    return Family("yolov5", make_loss, make_decode, make_select)


def _yolox_family() -> Family:
    def make_loss(hyp, num_class, input_size):
        cfg = YOLOXLossConfig(
            num_class=num_class,
            input_size=tuple(input_size),
            topk=hyp.get("topk", 13),
            center_radius=hyp.get("center_radius", 3.0),
            iou_type=hyp.get("iou_type", "ciou"),
            use_l1=hyp.get("use_l1", True),
            iou_loss_scale=hyp.get("iou_loss_scale", 5.0),
            cls_loss_scale=hyp.get("cls_loss_scale", 1.0),
            cof_loss_scale=hyp.get("cof_loss_scale", 1.0),
            l1_loss_scale=hyp.get("l1_loss_scale", 1.0),
            class_smooth_factor=hyp.get("class_smooth_factor", 1.0),
            use_focal_loss=hyp.get("use_focal_loss", False),
        )

        def loss_fn(preds, targets, balances):
            return yolox_loss(preds, targets, balances, cfg)

        return loss_fn, yolox_initial_balances()

    def make_decode(hyp, num_class, input_size):
        from .evaluation.yolox import decode_yolox

        return lambda preds: decode_yolox(preds, num_class)

    def make_select(hyp, num_class, input_size):
        from .evaluation.yolox import decode_topk_yolox

        def builder(eval_cfg):
            return lambda preds: decode_topk_yolox(
                preds, num_class, k=eval_cfg.num_candidates,
                conf_threshold=eval_cfg.conf_threshold, cls_threshold=eval_cfg.cls_threshold)

        return builder

    return Family("yolox", make_loss, make_decode, make_select)


def _yolov8_family() -> Family:
    def make_loss(hyp, num_class, input_size):
        cfg = YOLOv8LossConfig(  # the grid comes from the maps
            num_class=num_class,
            reg=hyp.get("reg", 16),
            topk=hyp.get("topk", 13),
            alpha=hyp.get("alpha", 0.5),
            beta=hyp.get("beta", 6.0),
            iou_loss_scale=hyp.get("iou_loss_scale", 7.5),
            cls_loss_scale=hyp.get("cls_loss_scale", 0.5),
            dfl_loss_scale=hyp.get("dfl_loss_scale", 1.5),
            cls_pos_weight=hyp.get("cls_pos_weight", 1.0),
            use_focal_factor=hyp.get("use_focal_loss", True),
            focal_loss_gamma=hyp.get("focal_loss_gamma", 1.5),
            focal_loss_alpha=hyp.get("focal_loss_alpha", 0.25),
        )

        def loss_fn(preds, targets, balances):
            return yolov8_loss(preds, targets, balances, cfg)

        return loss_fn, torch.ones(1)

    def make_decode(hyp, num_class, input_size):
        from .evaluation.yolov8 import decode_yolov8

        reg = hyp.get("reg", 16)
        return lambda preds: decode_yolov8(preds, num_class, reg=reg)

    def make_select(hyp, num_class, input_size):
        from .evaluation.yolov8 import decode_topk_yolov8

        reg = hyp.get("reg", 16)

        def builder(eval_cfg):
            return lambda preds: decode_topk_yolov8(
                preds, num_class, k=eval_cfg.num_candidates,
                conf_threshold=eval_cfg.conf_threshold, cls_threshold=eval_cfg.cls_threshold,
                reg=reg)

        return builder

    return Family("yolov8", make_loss, make_decode, make_select)


_FAMILIES: dict[str, Family] = {"yolov5": _yolov5_family(), "yolox": _yolox_family(),
                                "yolov8": _yolov8_family()}


def family_of(model_name: str, default: str | None = None) -> str:
    """Registry model name -> family key (longest prefix wins). Unknown
    names raise; pass ``default='yolov5'`` for custom models with YOLOv5
    heads (per-stage (B, A*(5+nc), H, W) maps at strides 8/16/32)."""
    for key in sorted((*_FAMILIES, *_NOT_PORTED), key=len, reverse=True):
        if model_name.startswith(key):
            return key
    if default is not None:
        return default
    raise KeyError(f"unknown model family for {model_name!r}; known prefixes: "
                   f"{sorted((*_FAMILIES, *_NOT_PORTED))} (pass default='yolov5' "
                   "for custom models with YOLOv5 heads)")


def get_family(model_name: str, default: str | None = None) -> Family:
    key = family_of(model_name, default)
    if key not in _FAMILIES:
        raise NotImplementedError(
            f"the {key} family (model, loss, decode) is not ported yet (ROADMAP A9)")
    return _FAMILIES[key]
