"""Fixed-shape batching on the host; counterpart of
``yoloseries_tpu/data/loader.py`` (no augmentation plans: ROADMAP A7).

* a seeded, rank-sharded infinite index stream,
* letterbox collate into static shapes: uint8 (B, H, W, 3) images and a
  -1-padded float32 (B, M, 6) annotation tensor [x1, y1, x2, y2, cls,
  img_idx] with a fixed M (boxes past M are dropped and counted),
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
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Queue

import numpy as np

from ..ops.letterbox import letterbox_boxes, letterbox_image

__all__ = ["infinite_indices", "collate_batch", "DataLoader"]

# Process workers are forked: each child inherits the dataset (its label
# cache and its memmap) and the image arena through this module's state
# when the pool starts. A task carries (idx, sample_id, seed, enable_aug,
# dst_hw, fill_value, slot) in; the worker letterboxes its sample into its
# slot of the arena, an anonymous shared mapping made before the fork, and
# sends back only the letterbox info and the boxes: on the card's host,
# moving every sample through the result pipe cost more than the workers
# saved. The children run numpy, PIL and cv2, never CUDA.
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


def _assemble(letterboxed, max_labels: int):
    """(letterboxed img, LetterboxInfo, boxes, classes) per sample -> the
    batch dict of ``collate_batch``."""
    batch = len(letterboxed)
    h, w = letterboxed[0][0].shape[:2]
    imgs = np.empty((batch, h, w, 3), dtype=np.uint8)
    anns = np.full((batch, max_labels, 6), -1.0, dtype=np.float32)
    infos = np.empty((batch, 5), dtype=np.float32)
    n_dropped = 0
    for i, (out, info, boxes, classes) in enumerate(letterboxed):
        imgs[i] = out
        infos[i] = info.as_array()
        n = min(len(boxes), max_labels)
        n_dropped += len(boxes) - n
        if n:
            anns[i, :n, 0:4] = letterbox_boxes(boxes[:n], info)
            anns[i, :n, 4] = classes[:n]
            anns[i, :n, 5] = i
    return {"img": imgs, "ann": anns, "info": infos, "n_dropped": n_dropped}


def collate_batch(samples, dst_size, max_labels: int, stride: int = 32,
                  fill_value: int = 114):
    """Letterbox + pad a list of (img uint8, boxes (N, 4) xyxy, classes (N,))
    into {img uint8 (B, H, W, 3), ann float32 (B, M, 6) -1 padded, info
    float32 (B, 5) [scale, pad_left, pad_top, org_w, org_h], n_dropped}."""
    hw = dst_size if not isinstance(dst_size, int) else (dst_size, dst_size)
    return _assemble([(*_letterbox(img, hw, fill_value, stride), boxes, classes)
                      for img, boxes, classes in samples], max_labels)


class DataLoader:
    """Loader of fixed-shape batches with a bounded prefetch queue.

    Samples are made by ``workers`` forked processes (``use_processes``; by
    default when there is more than one worker, more than one core and the
    fork start method), which also letterbox them into a shared arena, or
    else by threads: augmentation is numpy/cv2 work that threads serialize
    on the interpreter lock. One instance per process; under data
    parallelism give each process its (rank, world_size) so that the index
    streams do not overlap."""

    def __init__(self, dataset, batch_size: int, max_labels: int = 300, seed: int = 7,
                 rank: int = 0, world_size: int = 1, workers: int = 8, shuffle: bool = True,
                 infinite: bool = True, enable_aug: bool | None = None, prefetch: int = 2,
                 use_processes: bool | None = None):
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
        if use_processes is None:
            use_processes = (workers > 1 and (os.cpu_count() or 1) > 1
                             and mp.get_start_method(allow_none=True) in ("fork", None))
        self._proc_pool = None
        if use_processes:  # one arena slot per sample of a batch at the base size
            self._slot_bytes = self._input_size[0] * self._input_size[1] * 3
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
            fill = self.dataset.aug.fill_value
            try:
                if self._proc_pool is not None:
                    done = self._proc_pool.map(
                        _worker_load, [(i, sid, self.seed, self._enable_aug, self._input_size,
                                        fill, slot)
                                       for slot, (i, sid) in enumerate(zip(chunk, ids))])
                    batch = _assemble(
                        [(_arena_view(self._arena, slot, self._slot_bytes, out)
                          if isinstance(out, tuple) else out, *rest)
                         for slot, (out, *rest) in enumerate(done)], self.max_labels)
                else:
                    samples = list(self._pool.map(self._load_one, chunk, ids))
                    batch = collate_batch(samples, self._input_size, self.max_labels,
                                          fill_value=fill)
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
        result pipe's lock, which a worker blocked on a full pipe holds."""
        self._halt()
        if self._proc_pool is not None:
            self._proc_pool.close()
            self._proc_pool.join()
            self._proc_pool = self._arena = None
        self._pool.shutdown(wait=True)
