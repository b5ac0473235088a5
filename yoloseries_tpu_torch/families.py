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

Every family of the JAX package is ported: yolov5, yolox, yolov7, yolov8,
retinanet (and retinanet_experiment, its objectness variant) and fcos
(fcos_cspnet included). The eval overrides are the JAX package's: yolov7
zeroes boxes not above ``min_prediction_box_wh`` and gates candidates on
obj*cls (``conf_gate="v7"``), retinanet writes the merged boxes back, fcos
reports sqrt(ctr * cls), zeroes small boxes and gates the merge at 301
candidates. retinanet and fcos carry no balances: a (1,) vector passes
through their losses unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .losses.fcos import FCOSLossConfig, fcos_loss
from .losses.retinanet import RetinaNetLossConfig, retinanet_loss
from .losses.yolov5 import YOLOv5LossConfig, initial_balances, yolov5_loss
from .losses.yolov7 import YOLOv7LossConfig, yolov7_loss
from .losses.yolov8 import YOLOv8LossConfig, yolov8_loss
from .losses.yolox import YOLOXLossConfig, yolox_initial_balances, yolox_loss
from .ops.anchors import YOLOV5_ANCHORS

__all__ = ["Family", "get_family", "family_of"]


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


def _yolov7_family() -> Family:
    def make_loss(hyp, num_class, input_size):
        cfg = YOLOv7LossConfig(
            num_class=num_class,
            input_size=tuple(input_size),
            anchor_match_thr=hyp.get("anchor_match_thr", 4.0),
            topk=hyp.get("topk", 10),
            iou_loss_scale=hyp.get("iou_loss_scale", 0.05),
            cls_loss_scale=hyp.get("cls_loss_scale", 0.5),
            cof_loss_scale=hyp.get("cof_loss_scale", 1.0),
            cls_pos_weight=hyp.get("cls_pos_weight", 1.0),
            cof_pos_weight=hyp.get("cof_pos_weight", 1.0),
            use_iou_as_tar_cof=hyp.get("use_iou_as_tar_cof", True),
            use_focal_loss=hyp.get("use_focal_loss", False),
        )

        def loss_fn(preds, targets, balances):
            return yolov7_loss(preds, targets, YOLOV5_ANCHORS, balances, cfg)

        return loss_fn, initial_balances()

    def make_decode(hyp, num_class, input_size):  # YOLOv5's box formulas
        from .evaluation.yolov5 import yolov5_decode_fn

        return yolov5_decode_fn()

    def make_select(hyp, num_class, input_size):
        from .evaluation.yolov5 import yolov5_select_fn

        return yolov5_select_fn

    return Family("yolov7", make_loss, make_decode, make_select, eval_overrides=lambda hyp: {
        "min_box_wh": float(hyp.get("min_prediction_box_wh", 0.0)), "conf_gate": "v7"})


def _retinanet_anchors(preds):
    """The anchors of a ``RetinaNetOutput``'s maps, on their device."""
    from .evaluation.retinanet import anchors_for

    return anchors_for(tuple(preds.level_hw), preds[0].device)


def _retinanet_family(with_objectness: bool) -> Family:
    def make_loss(hyp, num_class, input_size):
        cfg = RetinaNetLossConfig(
            num_class=num_class,
            pos_iou_thr=hyp.get("positive_iou_thr", 0.5),
            neg_iou_thr=hyp.get("negative_iou_thr", 0.4),
            alpha=hyp.get("alpha", 0.25),
            gamma=hyp.get("gamma", 2.0),
            delta_scales=tuple(hyp.get("tar_box_scale_factor", (0.1, 0.1, 0.2, 0.2))),
            l1_loss_scale=hyp.get("l1_loss_scale", 0.5),
            iou_loss_scale=hyp.get("iou_loss_scale", 0.5),
            cls_loss_scale=hyp.get("cls_loss_scale", 0.2),
            iou_type=hyp.get("iou_type", "ciou"),
            with_objectness=with_objectness,
            cof_loss_scale=hyp.get("cof_loss_scale", 1.0),
        )

        def loss_fn(preds, targets, balances):
            return retinanet_loss(preds[0], preds[1], targets, _retinanet_anchors(preds),
                                  cfg), balances

        return loss_fn, torch.ones(1)

    def scales_of(hyp):
        return tuple(hyp.get("tar_box_scale_factor", (0.1, 0.1, 0.2, 0.2)))

    def make_decode(hyp, num_class, input_size):
        from .evaluation.retinanet import decode_retinanet

        scales = scales_of(hyp)
        return lambda preds: decode_retinanet(preds[0], preds[1], _retinanet_anchors(preds),
                                              scales, clip_size=tuple(input_size))

    def make_select(hyp, num_class, input_size):
        from .evaluation.retinanet import decode_topk_retinanet

        scales = scales_of(hyp)

        def builder(eval_cfg):
            return lambda preds: decode_topk_retinanet(
                preds[0], preds[1], _retinanet_anchors(preds), k=eval_cfg.num_candidates,
                conf_threshold=eval_cfg.conf_threshold, cls_threshold=eval_cfg.cls_threshold,
                delta_scales=scales, clip_size=tuple(input_size))

        return builder

    name = "retinanet_experiment" if with_objectness else "retinanet"
    return Family(name, make_loss, make_decode, make_select,
                  eval_overrides=lambda hyp: {"merge_write_boxes": True})


def _fcos_family() -> Family:
    def make_loss(hyp, num_class, input_size):
        cfg = FCOSLossConfig(
            num_class=num_class,
            input_size=tuple(input_size),
            center_sampling_radius=hyp.get("center_sampling_radius", 1.5),
            do_center_sampling=hyp.get("do_center_sampling", True),
            iou_type=hyp.get("iou_type", "giou"),
            cls_loss_weight=hyp.get("cls_loss_weight", 1.0),
            reg_loss_weight=hyp.get("reg_loss_weight", 1.0),
            ctr_loss_weight=hyp.get("ctr_loss_weight", 1.0),
            cls_pos_weight=hyp.get("cls_pos_weight", 1.0),
            ctr_pos_weight=hyp.get("ctr_pos_weight", 1.0),
            class_smooth_factor=hyp.get("class_smooth_factor", 0.0),
            eps=hyp.get("eps", 1e-6),
        )

        def loss_fn(preds, targets, balances):
            return fcos_loss(*preds, targets, cfg), balances

        return loss_fn, torch.ones(1)

    def make_decode(hyp, num_class, input_size):
        from .evaluation.fcos import decode_fcos

        return lambda preds: decode_fcos(*preds)

    def make_select(hyp, num_class, input_size):
        from .evaluation.fcos import decode_topk_fcos

        def builder(eval_cfg):
            return lambda preds: decode_topk_fcos(
                *preds, k=eval_cfg.num_candidates, conf_threshold=eval_cfg.conf_threshold,
                cls_threshold=eval_cfg.cls_threshold)

        return builder

    return Family("fcos", make_loss, make_decode, make_select, eval_overrides=lambda hyp: {
        "conf_sqrt": True, "min_box_wh": float(hyp.get("min_prediction_box_wh", 0.0)),
        "merge_gate_max": 301})


_FAMILIES: dict[str, Family] = {
    "yolov5": _yolov5_family(), "yolox": _yolox_family(), "yolov7": _yolov7_family(),
    "yolov8": _yolov8_family(), "fcos": _fcos_family(),
    "retinanet": _retinanet_family(False), "retinanet_experiment": _retinanet_family(True)}


def family_of(model_name: str, default: str | None = None) -> str:
    """Registry model name -> family key (longest prefix wins). Unknown
    names raise; pass ``default='yolov5'`` for custom models with YOLOv5
    heads (per-stage (B, A*(5+nc), H, W) maps at strides 8/16/32)."""
    for key in sorted(_FAMILIES, key=len, reverse=True):
        if model_name.startswith(key):
            return key
    if default is not None:
        return default
    raise KeyError(f"unknown model family for {model_name!r}; known prefixes: "
                   f"{sorted(_FAMILIES)} (pass default='yolov5' "
                   "for custom models with YOLOv5 heads)")


def get_family(model_name: str, default: str | None = None) -> Family:
    return _FAMILIES[family_of(model_name, default)]
