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

__all__ = [
    "EvalConfig",
    "Evaluator",
    "decode_topk_yolov5",
    "decode_yolov5",
    "scale_and_pad",
    "topk_gather",
    "yolov5_decode_fn",
    "yolov5_select_fn",
]
