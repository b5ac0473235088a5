from .augment import AugmentConfig, apply_transform_chain, mixup, mosaic4, valid_boxes_mask
from .builders import build_coco_dataset, build_voc_dataset
from .dataset import DetectionDataset, load_names
from .device_aug import plan_sample, render_batch
from .loader import DataLoader, collate_batch, collate_plan_batch, infinite_indices

__all__ = ["AugmentConfig", "DataLoader", "DetectionDataset", "apply_transform_chain",
           "build_coco_dataset", "build_voc_dataset", "collate_batch", "collate_plan_batch",
           "infinite_indices", "load_names", "mixup", "mosaic4", "plan_sample", "render_batch",
           "valid_boxes_mask"]
