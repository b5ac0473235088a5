"""A training set drawn from the run's seed: JPEGs of COCO's sizes (the long
side 640: 640x480, 480x640, 640x427, 640x640; scaled for another long
side) holding 1-12 filled boxes of
80 classes (sides of 16 px or more, aspect ratio under 10) on a smooth
background, with their txt labels
(``cls x1 y1 x2 y2`` in pixels) and a names file."""

from __future__ import annotations

import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SIZES = ((480, 640), (640, 480), (427, 640), (640, 640))


def _image(seed: int, i: int, colors, long_side: int):
    rng = np.random.default_rng((seed, i))
    h, w = (s * long_side // 640 for s in SIZES[int(rng.integers(0, len(SIZES)))])
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 60 + 40 * np.sin(yy / rng.uniform(20, 90)) * np.cos(xx / rng.uniform(20, 90))
    img = np.repeat(base[..., None], 3, axis=2).astype(np.uint8)
    lines = []
    for _ in range(int(rng.integers(1, 13))):
        # sides of 16 px or more and an aspect ratio under 10: no box is
        # dropped by the loader's box filter
        bw = int(rng.integers(16, w // 2))
        bh = int(rng.integers(max(16, -(-bw // 9)), min(h // 2, 9 * bw)))
        x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        c = int(rng.integers(0, 80))
        img[y1:y1 + bh, x1:x1 + bw] = colors[c]
        lines.append(f"{c} {x1} {y1} {x1 + bw} {y1 + bh}")
    return img, lines


def synthetic_set(root: Path, n: int, seed: int, long_side: int = 640, threads: int = 8):
    """Write the set under ``root`` (emptied first). Returns (img_dir,
    lab_dir, names file)."""
    from PIL import Image

    shutil.rmtree(root, ignore_errors=True)
    img_dir, lab_dir = root / "img", root / "lab"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir()
    colors = np.random.default_rng((seed, n)).integers(30, 226, (80, 3), dtype=np.uint8)

    def write(i):
        img, lines = _image(seed, i, colors, long_side)
        Image.fromarray(img).save(img_dir / f"{i:05d}.jpg", quality=90)
        (lab_dir / f"{i:05d}.txt").write_text("\n".join(lines) + "\n")

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(write, range(n)))
    names = root / "names.txt"
    names.write_text("".join(f"{c} class{c}\n" for c in range(80)))
    return img_dir, lab_dir, names
