"""Crop-classification dataset for the auxiliary classifier; a copy of
``yoloseries_tpu/data/classifier_data.py`` (numpy and PIL).

A folder of
detection crops whose filenames encode class and label
(``..._..._clsX_LAB_...`` — cls parsed from the 3rd underscore field after
stripping a 5-char prefix, label from the 4th, matching the reference's
``name.split('_')[2][5:]`` / ``[3]`` contract), resized to a fixed size and
ImageNet-normalized. Batches are numpy dicts {img (B,H,W,3) f32, cls (B,)
i32, lab list} ready for ``models/classifier.py::train_classifier`` (as (img, cls)).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image

__all__ = ["CropClassificationDataset", "crop_classifier_batches"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class CropClassificationDataset:
    def __init__(self, img_dir, img_size=(224, 224)):
        self.img_size = tuple(img_size)
        self.db = self._build_db(img_dir)

    @staticmethod
    def _build_db(img_dir):
        db = []
        for path in sorted(Path(img_dir).iterdir()):
            if not path.is_file() or path.suffix not in (".png", ".jpg"):
                continue
            fields = path.name.split("_")
            cls = fields[2][5:]  # reference field layout
            lab = fields[3]
            db.append((str(path), int(cls), lab))
        return db

    def __len__(self):
        return len(self.db)

    def __getitem__(self, idx):
        path, cls, lab = self.db[idx]
        img = Image.open(path).convert("RGB")
        if img.size[::-1] != self.img_size:
            img = img.resize(self.img_size[::-1], Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0
        arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
        return arr, cls, lab


def crop_classifier_batches(img_dir, img_size=(224, 224), batch_size=8,
                            shuffle=True, seed=0, epochs=1):
    """Generator of {img, cls, lab} batches (the last partial batch dropped,
    as the reference's loader drops it)."""
    ds = CropClassificationDataset(img_dir, img_size)
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(len(ds)) if shuffle else np.arange(len(ds))
        for s in range(0, len(ds) - batch_size + 1, batch_size):
            items = [ds[int(i)] for i in order[s : s + batch_size]]
            yield {
                "img": np.stack([x[0] for x in items]),
                "cls": np.asarray([x[1] for x in items], np.int32),
                "lab": [x[2] for x in items],
            }
