"""Port host augmentation, the augmented dataset, the image cache, the
loader's worker processes and the dataset builders against the JAX package.

* every augmenter of ``data/augment.py`` on seeded inputs: images, boxes,
  labels and the rng's next draw byte for byte (empty boxes and mosaic's
  "no box survived" branch included);
* ``DetectionDataset.get(..., enable_aug=True)`` under the preset's
  probabilities, uncached and with the cache (canvas and content crop; a
  cold build, then a warm start that decodes no image): byte-identical;
* the threaded ``DataLoader`` with augmentation on against the JAX one;
* the port's process loader (samples letterboxed into a shared arena, or
  sent by the pipe past the arena's size) against its own threads, in a
  fresh interpreter that imports no JAX (forking a process that holds JAX
  can deadlock);
* ``build_coco_dataset`` / ``build_voc_dataset`` on a tiny JSON and XML:
  identical trees.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import yoloseries_tpu.data.augment as jax_aug
import yoloseries_tpu_torch.data.augment as port_aug
from yoloseries_tpu.configs import TrainConfig as JaxTrainConfig
from yoloseries_tpu.configs import load_hyp as jax_load_hyp
from yoloseries_tpu.data.builders import build_coco_dataset as jax_build_coco
from yoloseries_tpu.data.builders import build_voc_dataset as jax_build_voc
from yoloseries_tpu.data.dataset import DetectionDataset as JaxDataset
from yoloseries_tpu.data.loader import DataLoader as JaxLoader
from yoloseries_tpu_torch.configs import TrainConfig
from yoloseries_tpu_torch.data import (DataLoader, DetectionDataset, build_coco_dataset,
                                       build_voc_dataset)

ROOT = Path(__file__).resolve().parent.parent
PRESET = ROOT / "yoloseries_tpu" / "configs" / "presets" / "train_yolov5.yaml"
SIZE = 64
NC = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------- augmenters

def _image(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = 90 + 60 * np.sin(yy / 7.0) * np.cos(xx / 5.0)
    img = base[..., None] + rng.integers(-40, 40, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _boxes(rng, h, w, n):
    xy = rng.uniform(0, [w * 0.6, h * 0.6], (n, 2))
    wh = rng.uniform(4, [w * 0.4, h * 0.4], (n, 2))
    return (np.concatenate([xy, xy + wh], 1).astype(np.float32),
            rng.integers(0, NC, n).astype(np.float32))


def _sample(rng, n=None):
    h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
    n = int(rng.integers(1, 6)) if n is None else n
    return (_image(rng, h, w), *_boxes(rng, h, w, n))


def _run(mod, case, seed):
    """Inputs from ``seed``; ``mod``'s function on them with a fresh rng.
    Returns its outputs and the rng's next draw."""
    data = np.random.default_rng(seed)
    rng = np.random.default_rng(seed + 1000)
    cfg = mod.AugmentConfig(input_size=(SIZE, SIZE), degrees=10.0, shear=4.0,
                            perspective=0.0 if case == "affine" else 0.0005)
    if case.startswith("mosaic4"):
        tiles = [_sample(data, n=0 if case == "mosaic4_empty" else None) for _ in range(4)]
        if case == "mosaic4_none_survive":  # every box off its tile: nothing kept
            tiles = [(im, b + 500.0, lab) for im, b, lab in tiles]
        imgs, boxes, labels = zip(*tiles)
        out = mod.mosaic4(list(imgs), list(boxes), list(labels), [2 * SIZE, 2 * SIZE], 114, rng)
    elif case == "mixup":
        a, b = _sample(data), _sample(data)
        b = (_image(data, *a[0].shape[:2]), b[1], b[2])
        out = mod.mixup(*a, *b, rng)
    elif case in ("perspective", "affine"):
        out = mod.random_perspective(*_sample(data), cfg, rng)
    elif case == "perspective_empty":
        out = mod.random_perspective(*_sample(data, n=0), cfg, rng)
    elif case == "perspective_boxes":
        img, boxes, labels = _sample(data, n=8)
        M, s = mod.sample_perspective_params(img.shape, cfg, rng, (SIZE, SIZE))
        out = (M, s, *mod.perspective_boxes(M, s, boxes, labels, SIZE, SIZE, True))
    elif case == "hsv":
        out = mod.random_hsv(_sample(data)[0], 1.0, 0.015, 0.7, 0.4, rng)
    elif case == "flip_lr":
        img, boxes, _ = _sample(data)
        out = mod.random_flip_lr(img, boxes, 0.5, rng) + mod.random_flip_lr(img, boxes, 1.0, rng)
    elif case == "flip_ud":
        img, boxes, _ = _sample(data)
        out = mod.random_flip_ud(img, boxes, 0.5, rng) + mod.random_flip_ud(img, boxes, 1.0, rng)
    elif case in ("cutout", "cutout_empty"):
        out = mod.cutout(*_sample(data, n=0 if case == "cutout_empty" else None), 0.3, 1.0, rng)
    elif case == "scale_jitting_up":  # dst larger than the image: the 0.5-1.5 branch
        out = mod.scale_jitting(*_sample(data), 1.0, rng, dst_size=(96, 96))
    elif case == "scale_jitting":
        out = mod.scale_jitting(*_sample(data), 1.0, rng)
    elif case == "blur":
        out = mod.random_blur(_sample(data)[0], 1.0, rng)
    elif case == "yoco":
        out = mod.yoco(_sample(data)[0],
                       lambda x: mod.random_hsv(x, 1.0, 0.015, 0.7, 0.4, rng))
    elif case in ("chain", "chain_empty"):
        cfg = dataclasses.replace(cfg, cutout_p=0.5, fliplr_p=0.5, flipud_p=0.5, blur_p=0.5,
                                  scale_jitting_p=0.5)
        out = mod.apply_transform_chain(*_sample(data, n=0 if case == "chain_empty" else None),
                                        cfg, rng)
    else:
        raise KeyError(case)
    out = out if isinstance(out, tuple) else (out,)
    return (*out, rng.random())


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, np.ndarray):
            g = np.asarray(g)
            assert (g.dtype, g.shape) == (w.dtype, w.shape), i
            assert g.tobytes() == w.tobytes(), i
        else:
            assert g == w, i


AUG_CASES = ["mosaic4", "mosaic4_empty", "mosaic4_none_survive", "mixup", "perspective",
             "affine", "perspective_empty", "perspective_boxes", "hsv", "flip_lr", "flip_ud",
             "cutout", "cutout_empty", "scale_jitting_up", "scale_jitting", "blur", "yoco",
             "chain", "chain_empty"]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", AUG_CASES)
def test_augmenter_matches_jax(case, seed):
    _assert_same(_run(port_aug, case, seed), _run(jax_aug, case, seed))


def test_mosaic_without_survivors_returns_the_first_tile():
    out = _run(port_aug, "mosaic4_none_survive", 0)
    data = np.random.default_rng(0)
    first = _sample(data)
    assert out[0].tobytes() == first[0].tobytes()
    assert np.array_equal(out[1], first[1] + 500.0)


# ------------------------------------------------------- the dataset

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """10 PNGs of assorted sizes with 0-4 boxes each (one image without
    labels), and names.txt."""
    root = tmp_path_factory.mktemp("port_augment")
    img_dir, lab_dir = root / "img", root / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    rng = np.random.default_rng(5)
    for i in range(10):
        h, w = int(rng.integers(40, 120)), int(rng.integers(40, 120))
        img = _image(rng, h, w)
        lines = []
        for _ in range(0 if i == 3 else int(rng.integers(1, 5))):
            bw, bh = int(rng.integers(8, w // 2)), int(rng.integers(8, h // 2))
            x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            c = int(rng.integers(0, NC))
            img[y1:y1 + bh, x1:x1 + bw] = (200, 60 + 60 * c, 40)
            lines.append(f"{c} {x1} {y1} {x1 + bw} {y1 + bh}")
        Image.fromarray(img).save(img_dir / f"{i:03d}.png")
        (lab_dir / f"{i:03d}.txt").write_text("".join(f"{ln}\n" for ln in lines))
    names = root / "names.txt"
    names.write_text("0 a\n1 b\n2 c\n")
    return img_dir, lab_dir, names


def _preset_aug():
    """The preset's augmentation at SIZE px, as both packages build it."""
    hyp = {**jax_load_hyp(PRESET), "input_img_size": [SIZE, SIZE]}
    want = JaxTrainConfig.from_hyp(hyp, num_class=NC).aug
    got = TrainConfig.from_hyp(hyp, num_class=NC).aug
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    return got, want


def _datasets(folder, tmp_path, cache, **kw):
    img_dir, lab_dir, names = folder
    aug, jaug = _preset_aug()
    extra = {}
    if cache != "none":
        extra = dict(cache_images=True, cached_canvas=cache == "canvas")
    ours = DetectionDataset(img_dir, lab_dir, names, input_size=(SIZE, SIZE), aug=aug,
                            enable_aug=True, cache_dir=tmp_path / "port", **extra, **kw)
    theirs = JaxDataset(img_dir, lab_dir, names, input_size=(SIZE, SIZE), aug=jaug,
                        enable_aug=True, cache_dir=tmp_path / "jax", **extra)
    return ours, theirs


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("cache", ["none", "canvas", "crop"])
def test_augmented_get_matches_jax(folder, tmp_path, cache, seed):
    ours, theirs = _datasets(folder, tmp_path, cache)
    for idx in range(len(ours)):
        for aug in (True, False):
            sid = seed * 100 + idx
            got = ours.get(idx, np.random.default_rng((seed, sid)), enable_aug=aug)
            want = theirs.get(idx, np.random.default_rng((seed, sid)), enable_aug=aug)
            _assert_same(got, want)


@pytest.mark.parametrize("canvas", [True, False])
def test_cache_cold_then_warm_matches_jax(folder, tmp_path, canvas, monkeypatch):
    cache = "canvas" if canvas else "crop"
    ours, theirs = _datasets(folder, tmp_path, cache)
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(files) == 2  # the .array and its .shapes.npy sidecar
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    for idx in range(len(ours)):
        _assert_same(ours.pull_item(idx), theirs.pull_item(idx))
    # a warm start reads the sidecar and decodes no image
    monkeypatch.setattr(DetectionDataset, "load_img",
                        lambda self, idx: pytest.fail("warm start decoded an image"))
    warm, _ = _datasets(folder, tmp_path, cache)
    assert warm.cached_canvas is canvas
    for idx in range(len(warm)):
        _assert_same(warm.pull_item(idx), theirs.pull_item(idx))
        got = warm.get(idx, np.random.default_rng(idx))
        want = theirs.get(idx, np.random.default_rng(idx))
        _assert_same(got, want)


def test_augmented_loader_matches_jax(folder, tmp_path):
    ours_ds, theirs_ds = _datasets(folder, tmp_path, "canvas")
    ours = DataLoader(ours_ds, batch_size=4, max_labels=12, seed=9, workers=2,
                      use_processes=False)
    theirs = JaxLoader(theirs_ds, batch_size=4, max_labels=12, seed=9, workers=2,
                       use_processes=False)
    try:
        for _ in range(3):  # past the first epoch's end
            got, want = next(ours), next(theirs)
            for k in ("img", "ann", "info"):
                assert got[k].tobytes() == want[k].tobytes(), k
    finally:
        ours.stop()
        theirs.stop()


PROCESS_CHECK = r"""
import os, sys
import numpy as np
from yoloseries_tpu_torch.data import DataLoader, DetectionDataset
from yoloseries_tpu_torch.data.augment import AugmentConfig

img_dir, lab_dir, names, cache_dir = sys.argv[1:5]
ds = DetectionDataset(img_dir, lab_dir, names, input_size=(64, 64),
                      aug=AugmentConfig(input_size=(64, 64)), enable_aug=True,
                      cache_images=True, cache_dir=cache_dir)

def batches(use_processes, n=3, **kw):
    loader = DataLoader(ds, batch_size=4, max_labels=12, seed=4, workers=3,
                        use_processes=use_processes, **kw)
    assert (loader._proc_pool is not None) == use_processes
    try:
        if loader.infinite:
            out = [next(loader) for _ in range(n)]
        else:
            out = list(loader)
            loader.restart()
            again = list(loader)
            assert [b["img"].tobytes() for b in again] == [b["img"].tobytes() for b in out]
        procs = loader._proc_pool._pool if use_processes else []
    finally:
        loader.stop()
    for p in procs:
        p.join(timeout=10)
        assert not p.is_alive()
    return out

for kw in ({}, {"shuffle": False, "infinite": False}):
    threads, processes = batches(False, **kw), batches(True, **kw)
    assert len(threads) == len(processes) >= 2
    for t, p in zip(threads, processes):
        for k in ("img", "ann", "info"):
            assert t[k].tobytes() == p[k].tobytes(), k
# a size past the arena's slots (multi-scale collate): the samples come by the pipe
grown = []
for use_processes in (False, True):
    loader = DataLoader(ds, batch_size=4, max_labels=12, seed=4, workers=3,
                        use_processes=use_processes)
    loader.set_input_size(96)
    grown.append([next(loader) for _ in range(6)])
    loader.stop()
assert grown[0][-1]["img"].shape[1] == grown[1][-1]["img"].shape[1] == 96
for t, p in zip(*grown):
    if t["img"].shape == p["img"].shape:
        for k in ("img", "ann", "info"):
            assert t[k].tobytes() == p[k].tobytes(), k
# the default on a host with more than one core: processes
loader = DataLoader(ds, batch_size=4, workers=2)
assert (loader._proc_pool is not None) == ((os.cpu_count() or 1) > 1)
next(loader)
loader.stop()
print("JAX" if any(m == "jax" or m.startswith("jax.") for m in sys.modules) else "NOJAX")
"""


def test_process_loader_matches_threads(folder, tmp_path):
    img_dir, lab_dir, names = folder
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", PROCESS_CHECK, str(img_dir), str(lab_dir), str(names),
         str(tmp_path)], cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[-1] == "NOJAX"


def test_join_pool_leaves_no_thread_behind():
    """A pool that ran cv2 is gone from the OS when ``join_pool`` returns,
    so that the next loader's fork catches none of its threads halfway out
    (cv2's thread-local destructors take a lock the child would inherit
    held); ``import_cv2`` holds cv2 to one thread, so that no cv2 pool
    thread runs at a fork either."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from yoloseries_tpu_torch.data.augment import import_cv2
    from yoloseries_tpu_torch.data.loader import join_pool

    cv2 = import_cv2()
    assert cv2.getNumThreads() == 1
    img = np.random.default_rng(0).integers(0, 256, (96, 96, 3), dtype=np.uint8)
    pool = ThreadPoolExecutor(max_workers=3)
    list(pool.map(lambda _: cv2.warpAffine(img, np.eye(2, 3), (96, 96)), range(6)))
    tids = [t.native_id for t in pool._threads]
    assert len(tids) == 3
    join_pool(pool)
    assert not any(Path(f"/proc/self/task/{t}").exists() for t in tids)
    assert all(t.native_id not in tids for t in threading.enumerate())


# ------------------------------------------------------------ builders

def _tree(root: Path) -> dict:
    out = {}
    for p in sorted(root.rglob("*")):
        rel = str(p.relative_to(root))
        if p.is_symlink():
            out[rel] = ("link", os.readlink(p))
        elif p.is_file():
            out[rel] = ("file", p.read_bytes())
    return out


@pytest.mark.parametrize("link", [True, False])
def test_coco_builder_matches_jax(tmp_path, link):
    src = tmp_path / "images"
    src.mkdir()
    for name in ("a.jpg", "b.jpg", "c.jpg"):
        (src / name).write_bytes(name.encode() * 10)
    coco = {
        "categories": [{"id": 7, "name": "dog"}, {"id": 2, "name": "cat"}],
        "images": [{"id": 1, "file_name": "a.jpg"}, {"id": 2, "file_name": "b.jpg"},
                   {"id": 3, "file_name": "c.jpg"}, {"id": 4, "file_name": "missing.jpg"}],
        "annotations": [
            {"image_id": 1, "bbox": [1.5, 2, 10, 20], "category_id": 7},
            {"image_id": 1, "bbox": [3, 4, 0.5, 9], "category_id": 2},  # under 1 px
            {"image_id": 1, "bbox": [0, 0, 5, 5], "category_id": 2, "iscrowd": 1},
            {"image_id": 2, "bbox": [10.25, 11, 30, 12.125], "category_id": 2},
        ],
    }
    ann = tmp_path / "instances.json"
    ann.write_text(json.dumps(coco))
    got = build_coco_dataset(ann, src, tmp_path / "port", link_images=link)
    want = jax_build_coco(ann, src, tmp_path / "jax", link_images=link)
    assert got == want == (3, 2)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


@pytest.mark.parametrize("split", [True, False])
def test_voc_builder_matches_jax(tmp_path, split):
    voc = tmp_path / "VOC"
    (voc / "Annotations").mkdir(parents=True)
    (voc / "JPEGImages").mkdir()
    objects = {"x1": [("car", 1, 2, 30, 40), ("person", 5.5, 6, 7, 80)],
               "x2": [("person", 0, 0, 10, 10)], "x3": []}
    for stem, objs in objects.items():
        body = "".join(f"<object><name>{n}</name><bndbox><xmin>{a}</xmin><ymin>{b}</ymin>"
                       f"<xmax>{c}</xmax><ymax>{d}</ymax></bndbox></object>"
                       for n, a, b, c, d in objs)
        (voc / "Annotations" / f"{stem}.xml").write_text(f"<annotation>{body}</annotation>")
        (voc / "JPEGImages" / f"{stem}.jpg").write_bytes(stem.encode())
    if split:
        (voc / "ImageSets" / "Main").mkdir(parents=True)
        (voc / "ImageSets" / "Main" / "trainval.txt").write_text("x2\nx1\nx9\n")
    got = build_voc_dataset(voc, tmp_path / "port")
    want = jax_build_voc(voc, tmp_path / "jax")
    assert got == want == ((2, 3) if split else (3, 3))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


# ------------------------------------------------ chip_smoke's digest

def test_chip_smoke_digest_batch_matches_jax(tmp_path, capsys):
    """The augmented batch whose sha256 ``chip_smoke.py`` phase 9 prints on
    the card: the same bytes from both packages here (this cv2); the digest,
    and those of each cv2 call on fixed inputs, are printed for comparison
    with the card's cv2 build."""
    import importlib.util

    import cv2

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    img_dir, lab_dir, _ = smoke.synthetic_folder(tmp_path / "digest", 8, seed=smoke.DIGEST_SEED)
    got = smoke.aug_digest(DetectionDataset, DataLoader, img_dir, lab_dir, tmp_path / "port",
                           use_processes=False)
    want = smoke.aug_digest(JaxDataset, JaxLoader, img_dir, lab_dir, tmp_path / "jax",
                            use_processes=False)
    assert got == want
    with capsys.disabled():
        print(f"\naugmented batch sha256 (cv2 {cv2.__version__}): {want}")
        print("cv2 calls, sha256[:16]: " + ", ".join(
            f"{k} {v}" for k, v in smoke.cv2_op_digests().items()))
