"""Fixed-shape batching on the host; counterpart of
``yoloseries_tpu/data/loader.py`` (thread workers, no augmentation plans).

* a seeded, rank-sharded infinite index stream,
* letterbox collate into static shapes: uint8 (B, H, W, 3) images and a
  -1-padded float32 (B, M, 6) annotation tensor [x1, y1, x2, y2, cls,
  img_idx] with a fixed M (boxes past M are dropped and counted),
* a thread pool and a bounded queue of prefetched batches. Each sample
  draws from its own ``np.random.default_rng((seed, sample_id))``, so
  batches are byte-identical to the JAX package's for one seed.

Batches stay numpy: the caller copies them to the card (the ``Trainer``
through pinned memory); /255 happens there.
"""

from __future__ import annotations

import itertools
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Queue

import numpy as np

from ..ops.letterbox import letterbox_boxes, letterbox_image

__all__ = ["infinite_indices", "collate_batch", "DataLoader"]


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


def collate_batch(samples, dst_size, max_labels: int, stride: int = 32,
                  fill_value: int = 114):
    """Letterbox + pad a list of (img uint8, boxes (N, 4) xyxy, classes (N,))
    into {img uint8 (B, H, W, 3), ann float32 (B, M, 6) -1 padded, info
    float32 (B, 5) [scale, pad_left, pad_top, org_w, org_h], n_dropped}."""
    batch = len(samples)
    h, w = dst_size if not isinstance(dst_size, int) else (dst_size, dst_size)
    imgs = np.empty((batch, h, w, 3), dtype=np.uint8)
    anns = np.full((batch, max_labels, 6), -1.0, dtype=np.float32)
    infos = np.empty((batch, 5), dtype=np.float32)
    n_dropped = 0
    for i, (img, boxes, classes) in enumerate(samples):
        out, info = letterbox_image(img, (h, w), stride=stride, fill_value=fill_value)
        if out.shape[:2] != (h, w):
            raise ValueError(f"letterbox produced {out.shape}, expected {(h, w)}; dst_size "
                             "must already be stride-aligned for static batching")
        imgs[i] = out
        infos[i] = info.as_array()
        n = min(len(boxes), max_labels)
        n_dropped += len(boxes) - n
        if n:
            anns[i, :n, 0:4] = letterbox_boxes(boxes[:n], info)
            anns[i, :n, 4] = classes[:n]
            anns[i, :n, 5] = i
    return {"img": imgs, "ann": anns, "info": infos, "n_dropped": n_dropped}


class DataLoader:
    """Threaded loader of fixed-shape batches with a bounded prefetch queue.

    One instance per process; under data parallelism give each process its
    (rank, world_size) so that the index streams do not overlap."""

    def __init__(self, dataset, batch_size: int, max_labels: int = 300, seed: int = 7,
                 rank: int = 0, world_size: int = 1, workers: int = 8, shuffle: bool = True,
                 infinite: bool = True, enable_aug: bool | None = None, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_labels = max_labels
        self.seed = seed
        self.infinite = infinite
        self.shuffle = shuffle
        self.rank = rank
        self.world_size = world_size
        self._enable_aug = dataset.enable_aug if enable_aug is None else enable_aug
        self._pool = ThreadPoolExecutor(max_workers=max(workers, 1))
        self._queue: Queue = Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._sample_counter = 0
        self.dropped_boxes = 0  # boxes lost to max_labels truncation
        self._warned_drop = False
        self._input_size = tuple(dataset.input_size)
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
            try:
                samples = list(self._pool.map(self._load_one, chunk, ids))
            except Exception as e:  # noqa: BLE001
                if self._stop.is_set():
                    return  # the pool was shut down by stop()
                self._queue.put(e)  # hand the failure to the consumer
                return
            batch = collate_batch(samples, self._input_size, self.max_labels,
                                  fill_value=self.dataset.aug.fill_value)
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
        """Stop the producer thread, dropping what it buffered."""
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
        streams, reusing the thread pool."""
        if self.infinite:
            raise ValueError("restart() only applies to finite loaders")
        self._halt()
        self._stop.clear()
        self._sample_counter = 0
        self._producer = threading.Thread(target=self._produce, daemon=True)
        self._producer.start()

    def stop(self):
        """Stop the producer and the worker threads."""
        self._halt()
        self._pool.shutdown(wait=True)
