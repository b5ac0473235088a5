from .fcos import decode_fcos, decode_topk_fcos
from .retinanet import decode_retinanet, decode_topk_retinanet
from .select import topk_gather
from .yolov5 import (
    EvalConfig,
    Evaluator,
    decode_topk_yolov5,
    decode_yolov5,
    scale_and_pad,
    yolov5_decode_fn,
    yolov5_select_fn,
)
from .yolov8 import decode_topk_yolov8, decode_yolov8
from .yolox import decode_topk_yolox, decode_yolox

__all__ = [
    "EvalConfig",
    "Evaluator",
    "decode_fcos",
    "decode_retinanet",
    "decode_topk_fcos",
    "decode_topk_retinanet",
    "decode_topk_yolov5",
    "decode_topk_yolov8",
    "decode_topk_yolox",
    "decode_yolov5",
    "decode_yolov8",
    "decode_yolox",
    "scale_and_pad",
    "topk_gather",
    "yolov5_decode_fn",
    "yolov5_select_fn",
]
