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
``cfg.remat`` and the hyp's ``s2d_stem``. Not ported yet, and raising when
asked for: ``per_replica_bn`` (ROADMAP A8). TensorBoard, the profiler
window and the model summary wait for A10.
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
from ..utils.meters import MeterBuffer
from .checkpoint import restore_checkpoint, save_checkpoint
from .optim import _group_schedule
from .state import create_train_state, make_train_step

if TYPE_CHECKING:
    from ..configs.config import TrainConfig

__all__ = ["Trainer"]


def _check_ported(cfg: "TrainConfig") -> None:
    """Raise for a setting that needs a module not ported yet."""
    if cfg.hyp.get("per_replica_bn", False):
        raise NotImplementedError("per_replica_bn (data parallelism) is not ported yet "
                                  "(ROADMAP A8)")


class Trainer:
    def __init__(self, cfg: "TrainConfig", train_dirs: tuple, val_dirs: tuple | None = None,
                 names_path=None, model_name: str | None = None,
                 compute_dtype=torch.float32, log_fn=print, device=None):
        self.device = resolve_device(device)
        _check_ported(cfg)
        self.cfg = cfg
        # per-rank log file: {output_dir}/log/log_rank_0/train.log
        self._log_file = None
        if cfg.hyp.get("save_log_txt", True):
            log_dir = Path(cfg.output_dir) / "log" / "log_rank_0"
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
        self.train_loader = DataLoader(
            self.train_dataset, batch_size=cfg.batch_size * cfg.accumulate,
            max_labels=cfg.max_labels, seed=cfg.seed, workers=cfg.num_workers,
            device_aug=cfg.device_aug, device_cache=cfg.device_cache)
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
        self.family = get_family(resolved_name, default=cfg.hyp.get("family"))
        loss_fn, balances0 = self.family.make_loss(cfg.hyp, self.num_class, cfg.input_size)
        decode_fn = self.family.make_decode(cfg.hyp, self.num_class, cfg.input_size)
        self.state = create_train_state(self.model, cfg.optim, balances=balances0,
                                        device=self.device)
        self._step_fns = {tuple(cfg.input_size): make_train_step(
            loss_fn, accumulate=cfg.accumulate, do_ema=cfg.do_ema,
            compute_dtype=compute_dtype)}

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
        self._val_loader = None
        if self._log_file is not None:
            print("hyp: " + ", ".join(f"{k}={cfg.hyp[k]}" for k in sorted(cfg.hyp)),
                  file=self._log_file)

    def _step_fn_for(self, size):
        """The train step of one multi-scale size. In interpolate mode the
        step resizes the base-size batch to ``size`` on the card; in collate
        mode the batch already arrives at ``size``."""
        size = tuple(size)
        if size not in self._step_fns:
            base = tuple(self.cfg.input_size)
            resize_to = size if self.multi_scale_mode == "interpolate" and size != base else None
            loss_fn, _ = self.family.make_loss(self.cfg.hyp, self.num_class, size)
            self._step_fns[size] = make_train_step(
                loss_fn, accumulate=self.cfg.accumulate, do_ema=self.cfg.do_ema,
                resize_to=resize_to, base_hw=base, compute_dtype=self._compute_dtype)
        return self._step_fns[size]

    # ------------------------------------------------------------------ io
    def save(self, step: int):
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
        for (_, t_data, t_iter, _), values in zip(pending, host):
            values = dict(zip(names, values))
            self.history.append(values)
            self.meters.update(data_time=t_data, iter_time=t_iter, **values)

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
                t0 = time.time()
                batch = self._device_batch(next(self.train_loader))
                t_data = time.time() - t0
                train_size = tuple(step_size or batch["img"].shape[1:3])
                self._last_train_size = train_size[0]
                self.state, metrics = self._step_fn_for(train_size)(self.state, batch)
                # no host sync here: the metrics are read at log points
                self._pending.append((global_it, t_data, time.time() - t0, metrics))
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
        return self.state

    # ---------------------------------------------------------------- eval
    def eval_variables(self) -> dict:
        """The EMA ``state_dict`` if it is tracked, else the live one."""
        return self.state.ema if self.cfg.do_ema else self.state.model.state_dict()

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
        """mAP over the val set at the protocol thresholds."""
        if self.val_dataset is None:
            raise ValueError("evaluate() needs val dirs")
        if self._val_loader is None:
            self._val_loader = DataLoader(
                self.val_dataset, batch_size=self.cfg.batch_size,
                max_labels=self.cfg.max_labels, workers=self.cfg.num_workers,
                shuffle=False, infinite=False, enable_aug=False)
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
        return out

    def close(self):
        """Stop the loaders' workers and close the log file."""
        self.train_loader.stop()
        if self._val_loader is not None:
            self._val_loader.stop()
            self._val_loader = None
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None
