from .augment import AugmentConfig, valid_boxes_mask
from .dataset import DetectionDataset, load_names
from .loader import DataLoader, collate_batch, infinite_indices

__all__ = ["AugmentConfig", "DataLoader", "DetectionDataset", "collate_batch",
           "infinite_indices", "load_names", "valid_boxes_mask"]
