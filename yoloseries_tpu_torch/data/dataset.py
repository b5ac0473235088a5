"""Folder-of-images + txt-label dataset (host side); counterpart of
``yoloseries_tpu/data/dataset.py`` without augmentation.

Layout:

    img_dir/000001.jpg ...
    lab_dir/000001.txt   lines: "class_id xmin ymin xmax ymax" (absolute px)
    names.txt            lines: "class_id name"

Labels are parsed fully; boxes with a side under 1 px are dropped. Images
are decoded with PIL, imported where an image is read. ``get(...,
enable_aug=False)`` serves the raw item with the validity filter and the
resample-until-nonempty loop of the JAX package, its rng draws included.
Host augmentation and the image cache are not ported yet (ROADMAP A6):
``get(..., enable_aug=True)`` and ``cache_images=True`` raise. When the
cache arrives it must serve full canvases by default (``cached_canvas``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .augment import AugmentConfig, valid_boxes_mask

__all__ = ["DetectionDataset", "load_names"]

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def load_names(path) -> dict[int, str]:
    """Parse names.txt: 'class_id name' per line."""
    out = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        idx, name = line.split(maxsplit=1)
        out[int(idx)] = name
    return out


class DetectionDataset:
    """Index of (image, label) pairs."""

    def __init__(self, img_dir, lab_dir, names_path=None, input_size=(640, 640),
                 aug: AugmentConfig | None = None, enable_aug: bool = False,
                 cache_images: bool = False):
        if cache_images:
            raise NotImplementedError(
                "the image cache (cv2 resize, full canvases) is not ported yet "
                "(ROADMAP A6)")
        self.img_dir = Path(img_dir)
        self.lab_dir = Path(lab_dir)
        self.input_size = tuple(input_size)
        self.aug = aug or AugmentConfig(input_size=tuple(input_size))
        self.enable_aug = enable_aug

        self.img_files = sorted(
            p for p in self.img_dir.iterdir() if p.suffix.lower() in IMG_EXTENSIONS
        )
        if not self.img_files:
            raise FileNotFoundError(f"no images under {self.img_dir}")
        missing = [p.name for p in self.img_files
                   if not (self.lab_dir / f"{p.stem}.txt").exists()]
        if missing:
            raise FileNotFoundError(
                f"{len(missing)} images lack label files, e.g. {missing[:3]}")

        self.cls2name = load_names(names_path) if names_path is not None else {}
        self._num_class = None
        self._ann_cache: dict = {}

    def __len__(self):
        return len(self.img_files)

    @property
    def num_class(self) -> int:
        if self.cls2name:
            return max(self.cls2name) + 1
        if self._num_class is None:
            classes = set()
            for idx in range(len(self.img_files)):
                classes.update(self.load_annotations(idx)[:, 0].astype(int).tolist())
            self._num_class = (max(classes) + 1) if classes else 1
        return self._num_class

    def load_img(self, idx: int) -> np.ndarray:
        from PIL import Image

        return np.asarray(Image.open(self.img_files[idx]).convert("RGB"))

    def load_annotations(self, idx: int) -> np.ndarray:
        """(N, 5) [cls, xmin, ymin, xmax, ymax]; boxes with a side under
        1 px dropped. Memoized; callers get a copy."""
        cached = self._ann_cache.get(idx)
        if cached is not None:
            return cached.copy()
        path = self.lab_dir / f"{self.img_files[idx].stem}.txt"
        try:
            ann = np.loadtxt(str(path), dtype=np.float32, ndmin=2)
        except (ValueError, OSError):
            ann = np.zeros((0, 5), dtype=np.float32)
        if ann.size == 0:
            ann = np.zeros((0, 5), dtype=np.float32)
        else:
            if ann.shape[1] != 5:
                raise ValueError(f"bad label shape {ann.shape} in {path}")
            whs = ann[:, [3, 4]] - ann[:, [1, 2]]
            ann = ann[np.all(whs >= 1, axis=1)]
        self._ann_cache[idx] = ann
        return ann.copy()

    def pull_item(self, idx: int):
        """Raw (img, boxes (N, 4) xyxy, classes (N,))."""
        ann = self.load_annotations(idx)
        return self.load_img(idx), ann[:, 1:5].copy(), ann[:, 0].copy()

    def get(self, idx: int, rng: np.random.Generator, enable_aug: bool | None = None):
        """One sample: (img uint8 HxWx3, boxes (N, 4) xyxy float32, classes
        (N,) float32). Resamples another index (up to 10 tries) while the
        valid boxes are empty, then gives up and returns the raw item."""
        if enable_aug is None:
            enable_aug = self.enable_aug
        if enable_aug:
            raise NotImplementedError(
                "host augmentation (mosaic, mixup, perspective, HSV) is not ported yet "
                "(ROADMAP A6): close it (no_data_aug_epoch >= total_epoch)")
        for _attempt in range(10):
            img, boxes, labels = self.pull_item(idx)
            if len(boxes):
                keep = valid_boxes_mask(boxes)
                boxes, labels = boxes[keep], labels[keep]
            if len(boxes) and boxes.sum() > 0:
                return img, boxes.astype(np.float32), labels.astype(np.float32)
            idx = int(rng.integers(0, len(self)))
        img, boxes, labels = self.pull_item(idx)
        return img, boxes.astype(np.float32), labels.astype(np.float32)
