"""Folder-of-images + txt-label dataset (host side); counterpart of
``yoloseries_tpu/data/dataset.py``.

Layout:

    img_dir/000001.jpg ...
    lab_dir/000001.txt   lines: "class_id xmin ymin xmax ymax" (absolute px)
    names.txt            lines: "class_id name"

Labels are parsed fully; boxes with a side under 1 px are dropped. Images
are decoded with PIL, imported where an image is read. ``get`` draws from
the caller's rng in the JAX package's order: with augmentation, mosaic
(with nested mixup) by probability, then the perspective / cutout / HSV /
blur / flip / jitter chain; then the validity filter and the
resample-until-nonempty loop.

``cache_images``: a uint8 memmap of every image resized by min(h/H, w/W)
into the input size, with a ``.shapes.npy`` sidecar of the cached and
original sizes, so that a warm start decodes no image. Cached items are
served as the full (h, w) canvas, content top-left and zeros beyond
(``cached_canvas``, on by default with the cache): that is what the
reference's cached loader trains on, and the JAX package matched the
reference's converged mAP only once it served canvases. ``pull_meta``
gives the device-aug planner (``data/device_aug.py``) the shape, boxes and
classes of an item without reading its pixels.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .augment import (
    AugmentConfig,
    apply_transform_chain,
    import_cv2,
    mixup,
    mosaic4,
    valid_boxes_mask,
)

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
                 cache_images: bool = False, cache_dir=None,
                 cached_canvas: bool | None = None):
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
        self._meta_cache: dict = {}

        self._cache = None  # (N, h, w, 3) uint8 memmap
        self._cache_shapes = None  # (N, 2) cached (rh, rw)
        self._orig_shapes = None  # (N, 2) original (H, W)
        self.cached_canvas = bool(cache_images) if cached_canvas is None else bool(cached_canvas)
        if cache_images:
            self._build_cache(cache_dir)

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

    def _build_cache(self, cache_dir):
        """Open (warm: the sidecar exists) or build (cold: decode and resize
        every image, 8 threads) the memmap cache, by default beside
        ``img_dir``."""
        from concurrent.futures import ThreadPoolExecutor

        from .loader import join_pool

        cv2 = import_cv2()

        h, w = self.input_size
        cache_dir = Path(cache_dir) if cache_dir else self.img_dir.parent
        cache_dir.mkdir(parents=True, exist_ok=True)
        cache_file = cache_dir / f"img_{self.img_dir.name}_cache_h{h}_w{w}_{len(self)}.array"
        shapes_file = cache_file.with_suffix(".shapes.npy")
        fresh = not (cache_file.exists() and shapes_file.exists())
        self._cache = np.memmap(cache_file, shape=(len(self), h, w, 3), dtype=np.uint8,
                                mode="w+" if fresh else "r+")
        if not fresh:
            shapes = np.load(shapes_file)
            self._cache_shapes = shapes[:, :2].copy()
            self._orig_shapes = shapes[:, 2:].copy()
            return
        self._cache_shapes = np.zeros((len(self), 2), dtype=np.int32)
        self._orig_shapes = np.zeros((len(self), 2), dtype=np.int32)

        def resize_one(i):
            img = self.load_img(i)
            r = min(h / img.shape[0], w / img.shape[1])
            rh, rw = int(img.shape[0] * r), int(img.shape[1] * r)
            self._cache_shapes[i] = (rh, rw)
            self._orig_shapes[i] = img.shape[:2]
            self._cache[i, :rh, :rw] = cv2.resize(img, (rw, rh), interpolation=cv2.INTER_LINEAR)

        pool = ThreadPoolExecutor(max_workers=8)
        try:
            list(pool.map(resize_one, range(len(self))))
        finally:
            join_pool(pool)  # a loader may fork next: see join_pool
        self._cache.flush()
        np.save(shapes_file, np.concatenate([self._cache_shapes, self._orig_shapes], 1))

    def pull_item(self, idx: int):
        """Raw (img, boxes (N, 4) xyxy, classes (N,)). With the cache, the
        cached image (its canvas or its content) and the boxes scaled by
        the cache's ratio min(h/H, w/W)."""
        ann = self.load_annotations(idx)
        boxes, classes = ann[:, 1:5].copy(), ann[:, 0].copy()
        if self._cache is not None:
            h, w = self.input_size
            H, W = self._orig_shapes[idx]
            boxes = boxes * min(h / H, w / W)
            if self.cached_canvas:
                return np.asarray(self._cache[idx]), boxes, classes
            rh, rw = self._cache_shapes[idx]
            return np.asarray(self._cache[idx, :rh, :rw]), boxes, classes
        return self.load_img(idx), boxes, classes

    def pull_meta(self, idx: int):
        """((h, w), boxes (N, 4) xyxy, classes (N,)) of the image that
        ``pull_item`` would serve (the canvas, the crop, or the file's size
        from its header), without reading pixel bytes. Memoized: the arrays
        are shared, so every consumer copies before it mutates."""
        cached = self._meta_cache.get(idx)
        if cached is not None:
            return cached
        ann = self.load_annotations(idx)
        boxes, classes = ann[:, 1:5].copy(), ann[:, 0].copy()
        if self._cache is not None:
            h, w = self.input_size
            H, W = self._orig_shapes[idx]
            boxes = boxes * min(h / H, w / W)
            hw = (int(h), int(w)) if self.cached_canvas else tuple(int(s) for s in
                                                                  self._cache_shapes[idx])
        else:
            from PIL import Image

            with Image.open(self.img_files[idx]) as im:
                w0, h0 = im.size
            hw = (int(h0), int(w0))
        out = (hw, boxes, classes)
        self._meta_cache[idx] = out
        return out

    def _mosaic(self, idx: int, rng: np.random.Generator):
        indices = [idx] + [int(rng.integers(0, len(self))) for _ in range(3)]
        rng.shuffle(indices)
        imgs, boxes, labels = [], [], []
        for i in indices:
            im, b, l = self.pull_item(i)
            imgs.append(im)
            boxes.append(b)
            labels.append(l)
        return mosaic4(imgs, boxes, labels, mosaic_shape=[2 * s for s in self.input_size],
                       fill_value=self.aug.fill_value, rng=rng)

    def get(self, idx: int, rng: np.random.Generator, enable_aug: bool | None = None):
        """One sample: (img uint8 HxWx3, boxes (N, 4) xyxy float32, classes
        (N,) float32). Resamples another index (up to 10 tries) while the
        valid boxes are empty, then gives up and returns the raw item."""
        if enable_aug is None:
            enable_aug = self.enable_aug
        for _attempt in range(10):
            # pull_item draws nothing from rng, so the item is read only
            # when mosaic does not replace it: the same bytes and draws as
            # the JAX package, which reads it first in every case
            if enable_aug and rng.random() < self.aug.mosaic_p:
                img, boxes, labels = self._mosaic(idx, rng)
                if rng.random() < self.aug.mixup_p:
                    im2, b2, l2 = self._mosaic(int(rng.integers(0, len(self))), rng)
                    img, boxes, labels = mixup(img, boxes, labels, im2, b2, l2, rng)
            else:
                img, boxes, labels = self.pull_item(idx)
            if enable_aug:
                img, boxes, labels = apply_transform_chain(img, boxes, labels, self.aug, rng)
            if len(boxes):
                keep = valid_boxes_mask(boxes)
                boxes, labels = boxes[keep], labels[keep]
            if len(boxes) and boxes.sum() > 0:
                return img, boxes.astype(np.float32), labels.astype(np.float32)
            idx = int(rng.integers(0, len(self)))
        img, boxes, labels = self.pull_item(idx)
        return img, boxes.astype(np.float32), labels.astype(np.float32)
