"""Detection drawing on the host; a copy of ``yoloseries_tpu/utils/visualize.py``
(cv2 and numpy: the JAX package's module imports JAX through its package).

Box renderers on numpy images, pred-vs-gt side-by-side panels, per-class
colors, COCO/VOC class-name tables and the console report per image. cv2 is
imported where it is called (``data/augment.py::import_cv2``: one thread),
so importing the port needs no cv2.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

import numpy as np

from ..data.augment import import_cv2

__all__ = [
    "COCO_NAMES",
    "VOC_NAMES",
    "class_colors",
    "draw_detections",
    "save_detection_image",
    "save_pred_vs_gt",
    "detection_report",
]

COCO_NAMES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]

VOC_NAMES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

# a small emoji table for the console detection report
_EMOJI = {
    "person": "🧍", "bicycle": "🚲", "car": "🚗", "motorcycle": "🏍️",
    "airplane": "✈️", "bus": "🚌", "train": "🚆", "truck": "🚚", "boat": "⛵",
    "bird": "🐦", "cat": "🐱", "dog": "🐶", "horse": "🐴", "sheep": "🐑",
    "cow": "🐮", "elephant": "🐘", "bear": "🐻", "zebra": "🦓",
    "giraffe": "🦒", "banana": "🍌", "apple": "🍎", "pizza": "🍕",
    "donut": "🍩", "cake": "🍰", "clock": "🕐", "book": "📚",
}


def class_colors(num_class: int, seed: int = 7) -> np.ndarray:
    """Deterministic bright per-class BGR colors, (num_class, 3) uint8."""
    rng = np.random.default_rng(seed)
    return rng.integers(64, 255, size=(num_class, 3), dtype=np.uint8)


def draw_detections(img, dets, names=None, colors=None, thickness=2):
    """Draw (n, 6) [x1, y1, x2, y2, conf, cls] boxes on an RGB uint8 image."""
    cv2 = import_cv2()
    img = np.ascontiguousarray(img.copy())
    if dets is None or len(dets) == 0:
        return img
    nc = int(max(dets[:, 5])) + 1 if colors is None else len(colors)
    colors = class_colors(max(nc, 1)) if colors is None else colors
    for x1, y1, x2, y2, conf, cls in np.asarray(dets):
        c = colors[int(cls) % len(colors)].tolist()
        p1, p2 = (int(x1), int(y1)), (int(x2), int(y2))
        cv2.rectangle(img, p1, p2, c, thickness)
        label = names[int(cls)] if names else str(int(cls))
        caption = f"{label} {conf:.2f}"
        (tw, th), _ = cv2.getTextSize(caption, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(img, (p1[0], p1[1] - th - 4), (p1[0] + tw, p1[1]), c, -1)
        cv2.putText(img, caption, (p1[0], p1[1] - 2), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, (20, 20, 20), 1)
    return img


def save_detection_image(img, dets, save_path, names=None):
    out = draw_detections(img, dets, names)
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    import_cv2().imwrite(str(save_path), out[:, :, ::-1])  # RGB -> BGR for cv2


def save_pred_vs_gt(img, preds, gts, save_path, names=None):
    """Side-by-side prediction | ground truth panel."""
    left = draw_detections(img, preds, names)
    gt6 = None
    if gts is not None and len(gts):
        gts = np.asarray(gts)
        gt6 = np.concatenate(
            [gts[:, :4], np.ones((len(gts), 1)), gts[:, 4:5]], axis=1
        )
    right = draw_detections(img, gt6, names)
    panel = np.concatenate([left, right], axis=1)
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    import_cv2().imwrite(str(save_path), panel[:, :, ::-1])


def detection_report(dets, names=None, use_emoji: bool = True) -> str:
    """Console line counting detections per class, emoji-fied when known."""
    if dets is None or len(dets) == 0:
        return "no detections"
    counts = Counter(int(c) for c in np.asarray(dets)[:, 5])
    parts = []
    for cls, n in sorted(counts.items()):
        label = names[cls] if names and cls < len(names) else str(cls)
        if use_emoji and label in _EMOJI:
            label = _EMOJI[label]
        parts.append(f"{n} {label}")
    return ", ".join(parts)
