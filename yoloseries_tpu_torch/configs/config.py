"""Config system: YAML -> flat dict -> typed sub-configs; counterpart of
``yoloseries_tpu/configs/config.py``.

Every top-level YAML section (loss_hyp / train_hyp / optimizer_hyp /
warm_up / data_hyp / nms_hyp / val_hyp) is flattened into one dict with the
keys of ``presets/train_yolov5.yaml``; ``TrainConfig.from_hyp`` lifts it into
the typed configs (explicit overrides win over the YAML). ``yaml`` is
imported by ``load_hyp`` only.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

from ..data.augment import AugmentConfig
from ..evaluation.yolov5 import EvalConfig
from ..losses.yolov5 import YOLOv5LossConfig
from ..train.optim import OptimizerConfig

__all__ = ["load_hyp", "TrainConfig"]


def load_hyp(yaml_path, overrides: dict | None = None) -> dict:
    """Load a reference-format YAML into one flat hyp dict."""
    import yaml

    raw = yaml.safe_load(Path(yaml_path).read_text()) or {}
    hyp: dict[str, Any] = {}
    for section, values in raw.items():
        if isinstance(values, dict):
            hyp.update(values)
        else:
            hyp[section] = values
    if overrides:
        hyp.update({k: v for k, v in overrides.items() if v is not None})
    return hyp


def _pad_to_stride(size, stride=32):
    if isinstance(size, int):
        size = [size, size]
    return tuple(int((s + stride - 1) // stride * stride) for s in size)


@dataclasses.dataclass
class TrainConfig:
    """Typed view over the flat hyp dict + run-level settings."""

    hyp: dict
    model: str = "yolov5s"
    input_size: tuple = (640, 640)
    batch_size: int = 64
    total_epochs: int = 300
    accumulate: int = 1
    max_labels: int = 300
    seed: int = 7
    num_workers: int = 8
    do_ema: bool = True
    # not ported yet: the Trainer raises when it is set (ROADMAP A1)
    remat: bool = False
    # render mosaic, mixup, warp, cutout and HSV on the card
    # (data/device_aug.py): the host's workers only plan each sample
    device_aug: bool = False
    # with device_aug, the resized train set lives on the card, and a batch
    # brings only plan scalars and labels (~N*h*w*3 bytes of device memory)
    device_cache: bool = False
    # memmap cache of min-scale-resized train images, served as full canvases
    cache_images: bool = False
    no_aug_epochs: int = 10
    val_every: int = 1
    save_every: int = 1
    output_dir: str = "runs"

    aug: AugmentConfig = None
    loss: YOLOv5LossConfig = None
    optim: OptimizerConfig = None
    eval: EvalConfig = None

    @classmethod
    def from_hyp(cls, hyp: dict, num_class: int, steps_per_epoch: int = 1000,
                 **overrides) -> "TrainConfig":
        input_size = _pad_to_stride(hyp.get("input_img_size", [640, 640]))
        batch_size = overrides.pop("batch_size", hyp.get("batch_size", 64))
        total_epochs = overrides.pop("total_epoch", hyp.get("total_epoch", 300))
        accumulate = max(
            1,
            int(round(hyp.get("accumulate_loss_step", batch_size) / batch_size)),
        )

        aug = AugmentConfig(
            perspective_p=hyp.get("data_aug_prespective_p", 1.0),
            degrees=hyp.get("data_aug_degree", 0.0),
            translate=hyp.get("data_aug_translate", 0.1),
            scale=hyp.get("data_aug_scale", 0.5),
            shear=hyp.get("data_aug_shear", 0.0),
            perspective=hyp.get("data_aug_prespective", 0.0005),
            hsv_p=hyp.get("data_aug_hsv_p", 1.0),
            hsv_hgain=hyp.get("data_aug_hsv_hgain", 0.015),
            hsv_sgain=hyp.get("data_aug_hsv_sgain", 0.7),
            hsv_vgain=hyp.get("data_aug_hsv_vgain", 0.4),
            mixup_p=hyp.get("data_aug_mixup_p", 0.3),
            fliplr_p=hyp.get("data_aug_fliplr_p", 0.3),
            flipud_p=hyp.get("data_aug_flipud_p", 0.0),
            fill_value=hyp.get("data_aug_fill_value", 114),
            mosaic_p=hyp.get("data_aug_mosaic_p", 1.0),
            cutout_p=hyp.get("data_aug_cutout_p", 0.3),
            cutout_iou_thr=hyp.get("data_aug_cutout_iou_thr", 0.3),
            scale_jitting_p=hyp.get("data_aug_scale_jitting_p", 0.0),
            blur_p=hyp.get("data_aug_blur_p", 0.0),
            input_size=input_size,
        )
        loss = YOLOv5LossConfig(
            num_class=num_class,
            input_size=input_size,
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
        optim = OptimizerConfig(
            optimizer=hyp.get("optimizer", "sgd"),
            basic_lr_per_img=hyp.get("basic_lr_per_img", 0.000625),
            batch_size=batch_size,
            weight_decay=hyp.get("weight_decay", 0.0001),
            momentum=hyp.get("momentum", 0.937),
            scheduler_type=hyp.get("scheduler_type", "linear"),
            lr_max_ds_scale=hyp.get("lr_max_ds_scale", 0.001),
            total_epochs=total_epochs,
            steps_per_epoch=steps_per_epoch,
            do_warmup=hyp.get("do_warmup", True),
            warmup_epochs=hyp.get("warmup_epoch", 3),
            warmup_bias_max_lr=hyp.get("warmup_bias_max_lr", 0.1),
            warmup_momentum=hyp.get("warmup_momentum", 0.8),
            # explicit hyp['warmup_steps'] pins the ramp length, bypassing
            # the reference's max(warmup_epoch*spe, 1000) floor
            # (train_yolov5.py:253) — used by small-scale parity runs where
            # a 1000-iter ramp would swallow the whole schedule
            warmup_steps_override=hyp.get("warmup_steps"),
        )
        eval_cfg = EvalConfig(
            conf_threshold=hyp.get("compute_metric_conf_threshold", 0.001),
            cls_threshold=hyp.get("compute_metric_cls_threshold", 0.001),
            iou_threshold=hyp.get("compute_metric_iou_threshold", 0.65),
            # pre-NMS candidate cap (the reference's fcos `pre_nms_topk`;
            # certified vs the uncapped oracle in tests/test_eval_oracle.py)
            num_candidates=hyp.get("eval_num_candidates",
                                   hyp.get("pre_nms_topk", 4096)),
            max_keep=hyp.get("max_predictions_per_img", 300),
            class_aware=hyp.get("agnostic", True),
            merge_boxes=hyp.get("postprocess_bbox", True),
            use_tta=hyp.get("use_tta", False),
        )
        kwargs = dict(
            hyp=hyp,
            input_size=input_size,
            batch_size=batch_size,
            total_epochs=total_epochs,
            accumulate=accumulate,
            seed=hyp.get("random_seed", 7),
            num_workers=hyp.get("num_workers", 8) or 8,
            do_ema=hyp.get("do_ema", True),
            remat=hyp.get("remat", False),
            device_aug=hyp.get("device_aug", False),
            device_cache=hyp.get("device_cache", False),
            cache_images=bool(hyp.get("cache_num", 0))
            or bool(hyp.get("cache_images", False))
            or bool(hyp.get("device_aug", False)),
            no_aug_epochs=hyp.get("no_data_aug_epoch", 10),
            val_every=hyp.get("validation_every", 1),
            save_every=hyp.get("save_ckpt_every", 1),
            aug=aug,
            loss=loss,
            optim=optim,
            eval=eval_cfg,
        )
        kwargs.update(overrides)  # explicit overrides win over YAML
        return cls(**kwargs)
