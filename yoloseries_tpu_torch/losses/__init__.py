from .common import bce_with_logits, focal_loss_factor
from .yolov5 import YOLOv5LossConfig, initial_balances, yolov5_loss
from .yolov8 import YOLOv8LossConfig, yolov8_loss
from .yolox import YOLOXLossConfig, yolox_initial_balances, yolox_loss

__all__ = ["YOLOXLossConfig", "YOLOv5LossConfig", "YOLOv8LossConfig", "bce_with_logits",
           "focal_loss_factor", "initial_balances", "yolov5_loss", "yolov8_loss",
           "yolox_initial_balances", "yolox_loss"]
