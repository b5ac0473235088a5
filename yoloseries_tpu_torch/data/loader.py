"""Fixed-shape batching on the host; counterpart of
``yoloseries_tpu/data/loader.py``.

* a seeded, rank-sharded infinite index stream,
* letterbox collate into static shapes: uint8 (B, H, W, 3) images and a
  -1-padded float32 (B, M, 6) annotation tensor [x1, y1, x2, y2, cls,
  img_idx] with a fixed M (boxes past M are dropped and counted),
* with ``device_aug``, augmentation plans instead of pixels
  (``data/device_aug.py``): the workers do the box work, the card renders
  the batch; with ``device_cache`` too, the plans index the image cache on
  the card and carry no pixels,
* worker processes (or threads) and a bounded queue of prefetched batches.
  Each sample draws from its own ``np.random.default_rng((seed,
  sample_id))``, so batches are byte-identical to the JAX package's for one
  seed, with threads or processes alike.

Batches stay numpy: the caller copies them to the card (the ``Trainer``
through pinned memory); /255 happens there.
"""

from __future__ import annotations

import itertools
import mmap
import multiprocessing as mp
import os
import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Queue

import numpy as np

from ..ops.letterbox import letterbox_boxes, letterbox_image
from ..ops.preprocess import letterbox_plan
from .augment import import_cv2
from .device_aug import N_TILES, device_aug_supported, plan_sample

__all__ = ["infinite_indices", "collate_batch", "collate_plan_batch", "DataLoader", "join_pool"]

# Process workers are forked: each child inherits the dataset (its label
# cache and its memmap) and the arena through this module's state when the
# pool starts. A task carries the sample's index, id, seed and arena slot
# in; the worker writes its pixels (the letterboxed image, or a pixel
# plan's tiles) into its slot of the arena, an anonymous shared mapping
# made before the fork, and sends back only the small rest: on the card's
# host, moving every sample through the result pipe cost more than the
# workers saved. The children run numpy, PIL and cv2, never CUDA.
_WORKER: dict = {}


def _worker_init(dataset, arena, slot_bytes):
    _WORKER.update(dataset=dataset, arena=arena, slot_bytes=slot_bytes)


def _arena_view(arena, slot: int, slot_bytes: int, shape) -> np.ndarray:
    """uint8 ``shape`` view of the arena's ``slot``."""
    return np.frombuffer(arena, np.uint8, count=int(np.prod(shape)),
                         offset=slot * slot_bytes).reshape(shape)


def _worker_load(args):
    idx, sample_id, seed, enable_aug, dst_hw, fill_value, slot = args
    rng = np.random.default_rng((seed, sample_id))
    img, boxes, classes = _WORKER["dataset"].get(idx, rng, enable_aug=enable_aug)
    out, info = _letterbox(img, dst_hw, fill_value)
    if out.nbytes <= _WORKER["slot_bytes"]:  # a larger multi-scale size goes by the pipe
        _arena_view(_WORKER["arena"], slot, _WORKER["slot_bytes"], out.shape)[...] = out
        out = out.shape
    return out, info, boxes, classes


def _worker_plan(args):
    """One sample's augmentation plan; a pixel plan's tiles go into the
    arena's slot (every slot holds 8 tiles when pixel plans are made)."""
    idx, sample_id, seed, with_pixels, slot = args
    plan, boxes, classes, plane_hw = plan_sample(
        _WORKER["dataset"], idx, np.random.default_rng((seed, sample_id)), with_pixels)
    if with_pixels:
        tiles = plan.pop("tiles")
        _arena_view(_WORKER["arena"], slot, _WORKER["slot_bytes"], tiles.shape)[...] = tiles
    return plan, boxes, classes, plane_hw


def join_pool(pool: ThreadPoolExecutor) -> None:
    """Shut ``pool`` down and return once its threads have left the OS.

    ``Thread.join`` returns before a thread's thread-local destructors have
    run, and cv2's take the lock of its thread-local storage. A fork in that
    window (the next loader's worker pool) hands the child that lock held,
    and the child's first cv2 call that registers its thread waits on it
    for good (``warpAffine``, ``getRotationMatrix2D``). So wait until each
    thread's ``/proc/self/task`` entry is gone (at most 10 s; where there is
    no ``/proc`` it never exists)."""
    threads = list(pool._threads)
    pool.shutdown(wait=True)
    deadline = time.monotonic() + 10.0
    tids = [t.native_id for t in threads if t.native_id is not None]
    while tids and time.monotonic() < deadline:
        tids = [t for t in tids if os.path.exists(f"/proc/self/task/{t}")]
        if tids:
            time.sleep(0.001)


def infinite_indices(size: int, seed: int, rank: int = 0, world_size: int = 1,
                     shuffle: bool = True):
    """Seeded infinite index stream, every ``world_size``-th from ``rank``."""
    rng = np.random.default_rng(seed)

    def stream():
        while True:
            if shuffle:
                yield from rng.permutation(size).tolist()
            else:
                yield from range(size)

    return itertools.islice(stream(), rank, None, world_size)


def _letterbox(img, dst_hw, fill_value: int, stride: int = 32):
    out, info = letterbox_image(img, dst_hw, stride=stride, fill_value=fill_value)
    if out.shape[:2] != tuple(dst_hw):
        raise ValueError(f"letterbox produced {out.shape}, expected {tuple(dst_hw)}; dst_size "
                         "must already be stride-aligned for static batching")
    return out, info


def _targets(items, max_labels: int) -> dict:
    """(LetterboxInfo, boxes, classes) per sample -> {ann (B, M, 6) with the
    boxes letterboxed, -1 padded; info (B, 5); n_dropped}."""
    anns = np.full((len(items), max_labels, 6), -1.0, dtype=np.float32)
    infos = np.empty((len(items), 5), dtype=np.float32)
    n_dropped = 0
    for i, (info, boxes, classes) in enumerate(items):
        infos[i] = info.as_array()
        n = min(len(boxes), max_labels)
        n_dropped += len(boxes) - n
        if n:
            anns[i, :n, 0:4] = letterbox_boxes(boxes[:n], info)
            anns[i, :n, 4] = classes[:n]
            anns[i, :n, 5] = i
    return {"ann": anns, "info": infos, "n_dropped": n_dropped}


def _assemble(letterboxed, max_labels: int):
    """(letterboxed img, LetterboxInfo, boxes, classes) per sample -> the
    batch dict of ``collate_batch``."""
    imgs = np.stack([out for out, *_ in letterboxed])
    return {"img": imgs, **_targets([rest for _, *rest in letterboxed], max_labels)}


def collate_batch(samples, dst_size, max_labels: int, stride: int = 32,
                  fill_value: int = 114):
    """Letterbox + pad a list of (img uint8, boxes (N, 4) xyxy, classes (N,))
    into {img uint8 (B, H, W, 3), ann float32 (B, M, 6) -1 padded, info
    float32 (B, 5) [scale, pad_left, pad_top, org_w, org_h], n_dropped}."""
    hw = dst_size if not isinstance(dst_size, int) else (dst_size, dst_size)
    return _assemble([(*_letterbox(img, hw, fill_value, stride), boxes, classes)
                      for img, boxes, classes in samples], max_labels)


def collate_plan_batch(samples, dst_size, max_labels: int, stride: int = 32):
    """Stack augmentation plans into one fixed-shape batch. The boxes are
    letterboxed on the host with ``collate_batch``'s arithmetic (each
    sample's plane to ``dst_size``); the pixels wait for ``render_batch``.

    samples: (plan dict, boxes (N, 4), classes (N,), plane_hw) each.
    Returns {plan: the stacked fields and lbox (B, 3) [scale, pad_left,
    pad_top], ann (B, M, 6), info (B, 5), dst_hw, n_dropped}, and tiles (B,
    8, th, tw, 3) uint8 for pixel plans (a cache plan carries img_ids and
    tile_off instead)."""
    h, w = dst_size if not isinstance(dst_size, int) else (dst_size, dst_size)
    infos = [letterbox_plan(plane_hw, (h, w), stride=stride) for *_, plane_hw in samples]
    out = _targets([(info, boxes, classes)
                    for info, (_, boxes, classes, _) in zip(infos, samples)], max_labels)
    plan = {k: np.stack([s[0][k] for s in samples]) for k in samples[0][0]}
    plan["lbox"] = np.asarray([(i.scale, i.pad_left, i.pad_top) for i in infos], np.float32)
    out.update(plan=plan, dst_hw=(h, w))
    if "tiles" in plan:
        out["tiles"] = plan.pop("tiles")
    return out


class DataLoader:
    """Loader of fixed-shape batches with a bounded prefetch queue.

    Samples are made by ``workers`` forked processes (``use_processes``; by
    default when there is more than one worker, more than one core and the
    fork start method), which also write their pixels into a shared arena,
    or else by threads: augmentation is numpy/cv2 work that threads
    serialize on the interpreter lock. One instance per process; under data
    parallelism give each process its (rank, world_size) so that the index
    streams do not overlap.

    ``device_aug``: while augmentation is on, batches are plans
    (``collate_plan_batch``) for ``render_batch`` on the card; a knob set
    the render cannot do (``device_aug_supported``) warns and augments on
    the host. ``device_cache``: the plans index the dataset's image cache
    (which must exist) instead of carrying tiles."""

    def __init__(self, dataset, batch_size: int, max_labels: int = 300, seed: int = 7,
                 rank: int = 0, world_size: int = 1, workers: int = 8, shuffle: bool = True,
                 infinite: bool = True, enable_aug: bool | None = None, prefetch: int = 2,
                 use_processes: bool | None = None, device_aug: bool = False,
                 device_cache: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_labels = max_labels
        self.seed = seed
        self.infinite = infinite
        self.shuffle = shuffle
        self.rank = rank
        self.world_size = world_size
        self._enable_aug = dataset.enable_aug if enable_aug is None else enable_aug
        self._input_size = tuple(dataset.input_size)
        self.device_aug = bool(device_aug)
        self.device_cache = bool(device_cache) and self.device_aug
        if self.device_aug and not device_aug_supported(dataset.aug):
            warnings.warn(
                "device_aug disabled for this run: blur_p/scale_jitting_p > 0 need the staged "
                "renderer, which requires perspective_p == 1.0 or mosaic_p == 0.0 (the sample "
                "plane must fit the input-size buffer); falling back to host augmentation",
                stacklevel=2)
            self.device_aug = self.device_cache = False
        if self.device_cache and dataset._cache is None:
            raise ValueError("device_cache needs the dataset image cache (cache_images=True): "
                             "plans index cached images")
        if use_processes is None:
            use_processes = (workers > 1 and (os.cpu_count() or 1) > 1
                             and mp.get_start_method(allow_none=True) in ("fork", None))
        self._proc_pool = None
        if use_processes:
            if "cv2" in sys.modules:  # no cv2 pool thread may run at the fork
                import_cv2()
            # one arena slot per sample of a batch: an image at the base size,
            # or the 8 tiles of a pixel plan
            tiles = N_TILES if self.device_aug and not self.device_cache else 1
            self._slot_bytes = tiles * self._input_size[0] * self._input_size[1] * 3
            self._arena = mmap.mmap(-1, batch_size * self._slot_bytes)
            self._proc_pool = mp.get_context("fork").Pool(
                workers, initializer=_worker_init,
                initargs=(dataset, self._arena, self._slot_bytes))
        self._pool = ThreadPoolExecutor(max_workers=max(workers, 1))
        self._queue: Queue = Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._sample_counter = 0
        self.dropped_boxes = 0  # boxes lost to max_labels truncation
        self._warned_drop = False
        self._producer = threading.Thread(target=self._produce, daemon=True)
        self._producer.start()

    def set_input_size(self, size):
        """Letterbox size of the batches produced from now on."""
        if isinstance(size, int):
            size = (size, size)
        self._input_size = tuple(size)

    def __len__(self):
        """Batches per epoch (drop_last)."""
        return max(len(self.dataset) // (self.batch_size * self.world_size), 1)

    def close_data_aug(self):
        self._enable_aug = False

    def _load_one(self, idx: int, sample_id: int):
        rng = np.random.default_rng((self.seed, sample_id))
        return self.dataset.get(idx, rng, enable_aug=self._enable_aug)

    def _plan_one(self, idx: int, sample_id: int):
        rng = np.random.default_rng((self.seed, sample_id))
        return plan_sample(self.dataset, idx, rng, with_pixels=not self.device_cache)

    def _make_batch(self, chunk, ids):
        """One batch from the samples ``chunk`` with sample ids ``ids``."""
        fill = self.dataset.aug.fill_value
        if self.device_aug and self._enable_aug:
            with_pixels = not self.device_cache
            if self._proc_pool is None:
                samples = list(self._pool.map(self._plan_one, chunk, ids))
            else:
                samples = self._proc_pool.map(
                    _worker_plan, [(i, sid, self.seed, with_pixels, slot)
                                   for slot, (i, sid) in enumerate(zip(chunk, ids))])
                if with_pixels:
                    hw = self.dataset.input_size
                    for slot, (plan, *_) in enumerate(samples):
                        plan["tiles"] = _arena_view(self._arena, slot, self._slot_bytes,
                                                    (N_TILES, *hw, 3))
            return collate_plan_batch(samples, self._input_size, self.max_labels)
        if self._proc_pool is None:
            samples = list(self._pool.map(self._load_one, chunk, ids))
            return collate_batch(samples, self._input_size, self.max_labels, fill_value=fill)
        done = self._proc_pool.map(
            _worker_load, [(i, sid, self.seed, self._enable_aug, self._input_size, fill, slot)
                           for slot, (i, sid) in enumerate(zip(chunk, ids))])
        return _assemble([(_arena_view(self._arena, slot, self._slot_bytes, out)
                           if isinstance(out, tuple) else out, *rest)
                          for slot, (out, *rest) in enumerate(done)], self.max_labels)

    def _produce(self):
        indices = infinite_indices(len(self.dataset), self.seed, self.rank, self.world_size,
                                   self.shuffle)
        if not self.infinite:
            indices = itertools.islice(indices, len(self) * self.batch_size)
        while not self._stop.is_set():
            chunk = list(itertools.islice(indices, self.batch_size))
            if len(chunk) < self.batch_size:
                self._queue.put(None)
                return
            ids = range(self._sample_counter, self._sample_counter + len(chunk))
            self._sample_counter += len(chunk)
            try:
                batch = self._make_batch(chunk, ids)
            except Exception as e:  # noqa: BLE001
                if self._stop.is_set():
                    return  # the pools were shut down by stop()
                self._queue.put(e)  # hand the failure to the consumer
                return
            dropped = batch.pop("n_dropped")
            if dropped:
                self.dropped_boxes += dropped
                if not self._warned_drop:
                    self._warned_drop = True
                    warnings.warn(
                        f"collate dropped {dropped} boxes beyond max_labels="
                        f"{self.max_labels} in one batch (total in "
                        "DataLoader.dropped_boxes)", stacklevel=1)
            self._queue.put(batch)

    def __iter__(self):
        return self

    def __next__(self):
        batch = self._queue.get()
        if batch is None:
            raise StopIteration
        if isinstance(batch, Exception):
            raise batch
        return batch

    def _halt(self):
        """Stop the producer thread once its batch in the making is done,
        dropping what it buffered."""
        self._stop.set()
        while self._producer.is_alive():
            try:
                self._queue.get(timeout=0.1)  # frees a producer blocked on put()
            except Empty:
                pass
        try:
            while True:
                self._queue.get_nowait()
        except Empty:
            pass

    def restart(self):
        """Re-arm a finite loader for another pass with the same sample
        streams, reusing the worker pools."""
        if self.infinite:
            raise ValueError("restart() only applies to finite loaders")
        self._halt()
        self._stop.clear()
        self._sample_counter = 0
        self._producer = threading.Thread(target=self._produce, daemon=True)
        self._producer.start()

    def stop(self):
        """Stop the producer, then the worker processes and threads.

        The producer finishes the batch it is making first (``_halt`` waits
        for it), so the pool is closed with no task in flight: a
        ``terminate()`` while workers send samples can deadlock on the
        result pipe's lock, which a worker blocked on a full pipe holds. The
        threads are gone from the OS when it returns (``join_pool``), so a
        loader made next may fork."""
        self._halt()
        if self._proc_pool is not None:
            self._proc_pool.close()
            self._proc_pool.join()
            self._proc_pool = self._arena = None
        join_pool(self._pool)
