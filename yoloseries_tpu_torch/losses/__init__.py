from .common import bce_with_logits, focal_loss_factor
from .yolov5 import YOLOv5LossConfig, initial_balances, yolov5_loss

__all__ = ["YOLOv5LossConfig", "bce_with_logits", "focal_loss_factor", "initial_balances",
           "yolov5_loss"]
