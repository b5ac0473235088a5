"""The Trainer: one loop over (model, family loss, decode); counterpart of
``yoloseries_tpu/train/trainer.py``.

* ``__init__``: datasets and loaders (the train set augmented, and cached
  when ``cache_images``; the val set neither; worker processes by the
  loader's default; with ``device_cache`` the image cache uploaded to the
  card once), the model, the optimizer groups, the family's loss and
  decode, the train state, the evaluator;
* ``train()``: epochs of updates through ``make_train_step`` (accumulated
  micro-batches, one optimizer and one EMA update each), the batches copied
  to the card from pinned memory (with ``device_aug``, plans that
  ``data/device_aug.py::render_batch`` renders there); the metrics stay on
  the device until a log point reads them all at once. Augmentation closes
  at the first epoch of the last ``no_aug_epochs``, with a checkpoint
  there;
* ``evaluate()``: mAP over the val set on the EMA weights, at the protocol
  config (conf .001, iou .65, K=4096: the NMS runs in B1, ``nms_greedy``);
* ``save()`` / ``load()``: checkpoints of the whole train state.

Runs on ``cuda`` unless the caller passes ``device="cpu"``; raises without
a card. The model knobs of the JAX ``Trainer``: ``compute_dtype`` (bf16
compute, f32 parameters, BN statistics, optimizer, EMA and loss sums),
``cfg.remat`` and the hyp's ``s2d_stem``.

Data parallelism (``train/ddp.py``), inside a process group of more than
one rank (``parallel/dist.py::init_from_env``): ``cfg.batch_size`` is the
global batch of one micro-batch, split evenly over the ranks (raises when
it does not divide), and each rank loads only its rows of the batches one
process would load. By default the step is one function of the global
batch (BN over it, the loss's global terms summed: YOLOv5; another family
raises ``NotImplementedError``, ROADMAP A8b); ``per_replica_bn: true``
keeps each rank's BN statistics and averages the gradients. Rank 0 writes
the checkpoints, TensorBoard, the profiler trace and the model summary;
each rank writes ``log/log_rank_{rank}/train.log``. ``evaluate()`` scores a
contiguous part of the val set on each rank and merges the statistics
(``DetectionMetrics.gather_across_processes``).

Observability: the hyp and the model summary (``utils/summary.py``) head
the log; ``enable_tensorboard`` writes the metrics as scalars under
``output_dir/tb`` (``torch.utils.tensorboard``; without the ``tensorboard``
package it logs one line and goes on, as the JAX ``Trainer`` does) when
they are read (the log points and the epoch ends, so the step gains no host
sync); ``enable_profiler: n`` writes a
``torch.profiler`` trace (with the card's activity on a card) of updates 1
to n (update 0, which autotunes, left out) to ``output_dir/profile``; the
JAX ``Trainer`` opens its trace at the same update.
"""

from __future__ import annotations

import copy
import time
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np
import torch
from torch.profiler import record_function

from ..data.dataset import DetectionDataset
from ..data.device_aug import render_batch, render_method, render_staged
from ..data.loader import DataLoader
from ..device import resolve_device
from ..evaluation.yolov5 import Evaluator
from ..families import get_family
from ..models import create_model
from ..ops.metrics import DetectionMetrics
from ..parallel.dist import all_reduce_sum, process_count, process_index, shard_range
from ..utils.meters import MeterBuffer
from .checkpoint import restore_checkpoint, save_checkpoint
from .ddp import GlobalBatch, PerReplica, set_sync_bn, sync_replica_stats
from .optim import _group_schedule
from .state import create_train_state, make_train_step

if TYPE_CHECKING:
    from ..configs.config import TrainConfig

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, cfg: "TrainConfig", train_dirs: tuple, val_dirs: tuple | None = None,
                 names_path=None, model_name: str | None = None,
                 compute_dtype=torch.float32, log_fn=print, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rank, self.world = process_index(), process_count()
        self.per_replica_bn = bool(cfg.hyp.get("per_replica_bn", False))
        if cfg.batch_size % self.world:
            raise ValueError(f"the global batch {cfg.batch_size} does not split over "
                             f"{self.world} ranks")
        self.family = get_family(model_name or cfg.model, default=cfg.hyp.get("family"))
        self._collective, self._loss_kw = None, {}
        if self.world > 1:
            if self.per_replica_bn:
                self._collective = PerReplica()
            elif not self.family.global_batch_loss:
                raise NotImplementedError(
                    f"the global-batch step of {self.family.name} over {self.world} ranks: "
                    "its loss does not reduce its batch terms over the ranks yet (ROADMAP "
                    "A8b); set per_replica_bn: true")
            else:
                self._collective, self._loss_kw = GlobalBatch(), {"reduce": all_reduce_sum}
        # per-rank log file: {output_dir}/log/log_rank_{rank}/train.log
        self._log_file = None
        if cfg.hyp.get("save_log_txt", True):
            log_dir = Path(cfg.output_dir) / "log" / f"log_rank_{self.rank}"
            log_dir.mkdir(parents=True, exist_ok=True)
            self._log_file = open(log_dir / "train.log", "a", buffering=1)

        def log(*parts):
            log_fn(*parts)
            if self._log_file is not None:
                print(time.strftime("%Y-%m-%d %H:%M:%S"), *parts, file=self._log_file)

        self.log = log

        self.train_dataset = DetectionDataset(train_dirs[0], train_dirs[1], names_path,
                                              input_size=cfg.input_size, aug=cfg.aug,
                                              enable_aug=True, cache_images=cfg.cache_images)
        self.num_class = self.train_dataset.num_class
        self.val_dataset = None
        if val_dirs is not None:
            self.val_dataset = DetectionDataset(val_dirs[0], val_dirs[1], names_path,
                                                input_size=cfg.input_size, aug=cfg.aug)
        # this rank's rows of each batch: of each micro-batch on the global
        # batch's path, of the whole batch per replica (JAX's shard_map split)
        part = None
        if self.world > 1:
            part = (self.rank, self.world, 1 if self.per_replica_bn else cfg.accumulate)
        self.train_loader = DataLoader(
            self.train_dataset, batch_size=cfg.batch_size * cfg.accumulate,
            max_labels=cfg.max_labels, seed=cfg.seed, workers=cfg.num_workers,
            device_aug=cfg.device_aug, device_cache=cfg.device_cache, part=part)
        # device_cache: the resized train set lives on the card, and a batch
        # brings only plan scalars and labels
        self._dev_cache = None
        if self.train_loader.device_cache:
            self._dev_cache = torch.from_numpy(
                np.ascontiguousarray(self.train_dataset._cache)).to(self.device)
        self.steps_per_epoch = max(
            len(self.train_dataset) // (cfg.batch_size * cfg.accumulate), 1)
        cfg.optim = type(cfg.optim)(
            **{**cfg.optim.__dict__, "steps_per_epoch": self.steps_per_epoch})

        resolved_name = model_name or cfg.model
        model_kw = {}  # only the knobs asked for: a registered model may take none
        if compute_dtype != torch.float32:
            model_kw["dtype"] = compute_dtype
        if cfg.remat:
            model_kw["remat"] = True
        if cfg.hyp.get("s2d_stem", False):
            model_kw["s2d_stem"] = True
        self.model = create_model(resolved_name, num_class=self.num_class, device="cpu",
                                  seed=cfg.seed, **model_kw)
        self._compute_dtype = compute_dtype
        if isinstance(self._collective, GlobalBatch):
            set_sync_bn(self.model)
        loss_fn, balances0 = self.family.make_loss(cfg.hyp, self.num_class, cfg.input_size,
                                                   **self._loss_kw)
        decode_fn = self.family.make_decode(cfg.hyp, self.num_class, cfg.input_size)
        self.state = create_train_state(self.model, cfg.optim, balances=balances0,
                                        device=self.device)
        self._step_fns = {tuple(cfg.input_size): make_train_step(
            loss_fn, accumulate=cfg.accumulate, do_ema=cfg.do_ema,
            compute_dtype=compute_dtype, collective=self._collective)}

        # multi-scale training: a fresh /32 size in [0.5x, 1.5x] of the base
        # each update; "interpolate" resizes the base-size batch on the card
        # (the reference's numerics), "collate" re-letterboxes later batches
        # at the new size, redrawn every 10 updates
        self.multi_scale_sizes = []
        if cfg.hyp.get("mutil_scale_training") or cfg.hyp.get("multi_scale_training"):
            base = cfg.input_size[0]
            lo = max(round(base * 0.5 / 32) * 32, 64)
            hi = round(base * 1.5 / 32) * 32
            self.multi_scale_sizes = list(range(lo, hi + 1, 32))
        self.multi_scale_mode = cfg.hyp.get("multi_scale_mode", "interpolate")
        if self.multi_scale_mode not in ("interpolate", "collate"):
            raise ValueError(f"multi_scale_mode {self.multi_scale_mode!r}: "
                             "'interpolate' or 'collate'")
        self._ms_rng = np.random.default_rng(cfg.seed + 1)

        self.meters = MeterBuffer()
        eval_cfg = self.family.apply_eval_overrides(cfg.eval, cfg.hyp)
        select_builder = (self.family.make_select(cfg.hyp, self.num_class, cfg.input_size)
                          if self.family.make_select else None)
        # the evaluator runs a second module that holds the eval weights
        self._eval_model = copy.deepcopy(self.model)
        self.evaluator = Evaluator(self._eval_model, decode_fn, eval_cfg,
                                   select_fn=select_builder(eval_cfg) if select_builder else None,
                                   device=self.device)
        self.start_epoch = 0
        self.ckpt_dir = Path(cfg.output_dir) / "checkpoints"
        self._log_every = int(cfg.hyp.get("save_log_every", 50) or 0)
        self._lr_schedule = _group_schedule(cfg.optim, 0.0)
        # (global_it, data_t, iter_t, device metrics), read at log points
        self._pending = []
        self.history = []  # the metrics of every update, once read
        self.last_eval = None  # the metrics of the last evaluate()
        self._val_loader = None

        # TensorBoard scalars and the profiler window, on rank 0
        self.writer = None
        if cfg.hyp.get("enable_tensorboard") and self.rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as err:  # the tensorboard package is optional
                self.log(f"tensorboard disabled: {err}")
            else:
                self.writer = SummaryWriter(log_dir=str(Path(cfg.output_dir) / "tb"))
        self._profile_steps = int(cfg.hyp.get("enable_profiler", 0) or 0) if self.rank == 0 else 0
        self._profile_dir = Path(cfg.output_dir) / "profile"
        self._profiler = None
        # header: the hyp table, and on rank 0 the model summary
        if self._log_file is not None:
            from ..utils.summary import format_hyp_table, summarize_model

            print(format_hyp_table(cfg.hyp), file=self._log_file)
            if self.rank == 0:
                s = summarize_model(self.model, (1, 3, *cfg.input_size))
                print(f"model {resolved_name}: {s['params']:,} params, {s['param_bytes']:,} "
                      f"bytes, {s['gflops']:.2f} GFLOPs (convolutions and matmuls) @ "
                      f"{tuple(cfg.input_size)}", file=self._log_file)

    def _step_fn_for(self, size):
        """The train step of one multi-scale size. In interpolate mode the
        step resizes the base-size batch to ``size`` on the card; in collate
        mode the batch already arrives at ``size``."""
        size = tuple(size)
        if size not in self._step_fns:
            base = tuple(self.cfg.input_size)
            resize_to = size if self.multi_scale_mode == "interpolate" and size != base else None
            loss_fn, _ = self.family.make_loss(self.cfg.hyp, self.num_class, size,
                                               **self._loss_kw)
            self._step_fns[size] = make_train_step(
                loss_fn, accumulate=self.cfg.accumulate, do_ema=self.cfg.do_ema,
                resize_to=resize_to, base_hw=base, compute_dtype=self._compute_dtype,
                collective=self._collective)
        return self._step_fns[size]

    # ------------------------------------------------------------------ io
    def save(self, step: int):
        if self.rank == 0:
            save_checkpoint(self.ckpt_dir, self.state, step, hyp=self.cfg.hyp)

    def load(self):
        self.state, step = restore_checkpoint(self.ckpt_dir, self.state)
        if step is not None:
            self.start_epoch = int(step) // self.steps_per_epoch
            self.log(f"resumed from step {step} (epoch {self.start_epoch})")

    # --------------------------------------------------------------- train
    def _to_device(self, arrays: dict) -> dict:
        """numpy arrays to the card in one asynchronous copy: packed into
        one pinned buffer, copied ``non_blocking``, then viewed apart."""
        if self.device.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in arrays.items()}
        spans, size = {}, 0
        for k, a in arrays.items():
            spans[k] = (size, a)
            size += -(-a.nbytes // 16) * 16  # every view 16-byte aligned
        host = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        flat = host.numpy()
        for off, a in spans.values():
            flat[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        card = host.to(self.device, non_blocking=True)
        return {k: card[off:off + a.nbytes].view(torch.from_numpy(np.empty(0, a.dtype)).dtype)
                .reshape(a.shape) for k, (off, a) in spans.items()}

    def _device_batch(self, batch):
        """A batch on the card: uint8 images and f32 targets, or a plan
        batch's fields, rendered there into the images."""
        with record_function("train.h2d"):
            if "plan" not in batch:
                return self._to_device({"img": batch["img"], "ann": batch["ann"]})
            arrays = {**batch["plan"], "ann": batch["ann"]}
            if "tiles" in batch:
                arrays["tiles"] = batch["tiles"]
            out = self._to_device(arrays)
        aug = self.train_dataset.aug
        with record_function("train.render"):
            img = render_batch(out.pop("tiles", None), out, out_hw=batch["dst_hw"],
                               tile_hw=self.train_dataset.input_size, fill=aug.fill_value,
                               lb_fill=aug.fill_value, method=render_method(aug),
                               cache=self._dev_cache, staged=render_staged(aug))
        return {"img": img, "ann": out["ann"]}

    def _flush_metrics(self):
        """Read every queued metric of the device in one transfer and feed
        the meters."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        names = sorted(pending[0][3])
        host = torch.stack([torch.stack([m[n].float() for n in names])
                            for (_, _, _, m) in pending]).cpu().tolist()
        for (global_it, t_data, t_iter, _), values in zip(pending, host):
            values = dict(zip(names, values))
            self.history.append(values)
            self.meters.update(data_time=t_data, iter_time=t_iter, **values)
            if self.writer is not None:
                for k, v in values.items():
                    self.writer.add_scalar(f"train/{k}", v, global_it)
        if self.writer is not None:
            self.writer.flush()

    def _log_progress(self, epoch, total, it, global_it):
        total_iters = total * self.steps_per_epoch
        done = global_it + 1
        iter_t = self.meters["iter_time"].avg
        eta_s = (total_iters - done) * iter_t if iter_t else 0.0
        eta = time.strftime("%H:%M:%S", time.gmtime(min(eta_s, 86399)))
        if eta_s >= 86400:
            eta = f"{int(eta_s // 86400)}d {eta}"
        self.log(
            f"[{epoch + 1:>3d}/{total}] {done / total_iters:6.2%} "
            f"it {it + 1}/{self.steps_per_epoch} "
            f"loss {self.meters['tot_loss'].latest:.3f} "
            f"lr {self._lr_schedule(global_it):.3e} "
            f"size {self._last_train_size} "
            f"iter {iter_t:.3f}s data {self.meters['data_time'].avg:.3f}s eta {eta}")

    def train(self, epochs: int | None = None, eval_fn=None):
        cfg = self.cfg
        total = epochs or cfg.total_epochs
        aug_closed = False
        for epoch in range(self.start_epoch, total):
            if not aug_closed and cfg.no_aug_epochs > 0 and epoch >= total - cfg.no_aug_epochs:
                self.train_loader.close_data_aug()
                aug_closed = True
                self.log("data augmentation closed for final epochs")
                self.save(epoch * self.steps_per_epoch)
            t_epoch = time.time()
            metrics = {}
            for it in range(self.steps_per_epoch):
                global_it = epoch * self.steps_per_epoch + it
                step_size = None
                if self.multi_scale_sizes:
                    if self.multi_scale_mode == "interpolate":
                        s = int(self._ms_rng.choice(self.multi_scale_sizes))
                        step_size = (s, s)
                    elif global_it % 10 == 0:
                        self.train_loader.set_input_size(
                            int(self._ms_rng.choice(self.multi_scale_sizes)))
                if self._profile_steps and global_it == 1:
                    self._start_profiler()
                t0 = time.time()
                batch = self._device_batch(next(self.train_loader))
                t_data = time.time() - t0
                train_size = tuple(step_size or batch["img"].shape[1:3])
                self._last_train_size = train_size[0]
                self.state, metrics = self._step_fn_for(train_size)(self.state, batch)
                # no host sync here: the metrics are read at log points
                self._pending.append((global_it, t_data, time.time() - t0, metrics))
                if self._profiler is not None and global_it == self._profile_steps:
                    self._stop_profiler()
                if self._log_every and (global_it + 1) % self._log_every == 0:
                    self._flush_metrics()
                    self._log_progress(epoch, total, it, global_it)
            self._flush_metrics()
            parts = " ".join(f"{k.replace('_loss', '')} {self.meters[k].avg:.3f}"
                             for k in sorted(metrics)
                             if k.endswith("_loss") and k != "tot_loss")
            self.log(f"epoch {epoch + 1}/{total} loss {self.meters['tot_loss'].avg:.3f} "
                     f"({parts}) targets {self.meters['tar_nums'].avg:.0f} "
                     f"{time.time() - t_epoch:.1f}s")
            if (epoch + 1) % cfg.save_every == 0:
                self.save(self.state.step)
            if eval_fn is not None and (epoch + 1) % cfg.val_every == 0:
                eval_fn(self)
        if self._profiler is not None:  # the run ended inside the window
            self._stop_profiler()
        return self.state

    def _start_profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.start()

    def _stop_profiler(self):
        self._profiler.stop()
        self._profile_dir.mkdir(parents=True, exist_ok=True)
        self._profiler.export_chrome_trace(str(self._profile_dir / "trace.json"))
        self._profiler = None
        self.log(f"profiler trace saved to {self._profile_dir}")

    # ---------------------------------------------------------------- eval
    def eval_variables(self) -> dict:
        """The EMA ``state_dict`` if it is tracked, else the live one; per
        replica, its BN running statistics averaged over the ranks first."""
        sd = self.state.ema if self.cfg.do_ema else self.state.model.state_dict()
        if self.per_replica_bn and self.world > 1:
            sd = sync_replica_stats(sd)
        return sd

    def _accumulate_eval(self, metrics, dets, batch):
        """One batch's detections to the host, (gt, pred) pairs added."""
        preds = Evaluator.to_host_detections(dets, batch["info"])
        anns = batch["ann"]
        for i in range(len(preds)):
            valid = anns[i][:, 4] >= 0
            gt = anns[i][valid]
            scale, pl, pt, ow, oh = batch["info"][i]
            g = np.zeros((valid.sum(), 5), dtype=np.float64)
            g[:, 0] = ((gt[:, 0] - pl) / scale).clip(0, ow)
            g[:, 1] = ((gt[:, 1] - pt) / scale).clip(0, oh)
            g[:, 2] = ((gt[:, 2] - pl) / scale).clip(0, ow)
            g[:, 3] = ((gt[:, 3] - pt) / scale).clip(0, oh)
            g[:, 4] = gt[:, 4]
            metrics.add_image(g, preds[i])

    def evaluate(self, max_batches: int | None = None) -> dict:
        """mAP over the val set at the protocol thresholds; with more than
        one rank, each scores its contiguous part of the set in batches of
        ``batch_size / world`` and the statistics are merged in rank
        order."""
        if self.val_dataset is None:
            raise ValueError("evaluate() needs val dirs")
        if self._val_loader is None:
            batch = self.cfg.batch_size // self.world
            dataset = self.val_dataset
            if self.world > 1:
                dataset = dataset.subset(*shard_range(len(dataset), batch, self.rank,
                                                      self.world))
            self._val_loader = DataLoader(
                dataset, batch_size=batch, max_labels=self.cfg.max_labels,
                workers=self.cfg.num_workers, shuffle=False, infinite=False, enable_aug=False)
        else:
            self._val_loader.restart()
        self._eval_model.load_state_dict(self.eval_variables())
        metrics = DetectionMetrics()
        # batch i's detections are read while batch i + 1 is enqueued
        pending = None
        for bi, batch in enumerate(self._val_loader):
            if max_batches is not None and bi >= max_batches:
                break
            dets = self.evaluator(batch["img"])
            if pending is not None:
                self._accumulate_eval(metrics, *pending)
            pending = (dets, batch)
        if pending is not None:
            self._accumulate_eval(metrics, *pending)
        out = metrics.gather_across_processes().compute()
        self.log(f"mAP {out['map']:.4f} mAP50 {out['map50']:.4f} "
                 f"P {out['mp']:.4f} R {out['mr']:.4f}")
        self.last_eval = out
        return out

    def close(self):
        """Stop the loaders' workers and close the log file and the event
        file."""
        self.train_loader.stop()
        if self.writer is not None:
            self.writer.close()
        if self._val_loader is not None:
            self._val_loader.stop()
            self._val_loader = None
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None
