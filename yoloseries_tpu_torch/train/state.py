"""Train state and the train step; counterpart of
``yoloseries_tpu/train/state.py``.

``TrainState`` holds the module (its parameters and BN running stats), the
optimizer with its per-group state, the EMA ``state_dict``, the EMA update
count, the loss balances and the update count. ``make_train_step`` builds
one update: k micro-batches (``accumulate``) with the BN stats and the
balances threaded through them, the gradients summed and divided by k, one
optimizer update and one EMA update per call.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..losses.yolov5 import YOLOv5LossConfig, initial_balances, yolov5_loss
from ..utils.trace import span, warmup
from .ema import ema_update
from .optim import Optimizer, OptimizerConfig, build_optimizer

__all__ = ["TrainState", "create_train_state", "make_train_step", "resize_batch"]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    ema: dict  # name -> tensor, the EMA of model.state_dict()
    ema_count: float  # EMA updates applied
    balances: torch.Tensor  # per-stage conf-loss balance state
    step: int = 0  # optimizer updates applied


def create_train_state(model: nn.Module, optim_cfg: OptimizerConfig, num_stages: int = 3,
                       balances=None, state_dict: dict | None = None,
                       device=None) -> TrainState:
    """Wrap ``model`` (after loading ``state_dict`` when given, moved to
    ``device`` when given) with a fresh optimizer and an EMA equal to the
    weights."""
    if state_dict is not None:
        model.load_state_dict(state_dict)
    if device is not None:
        model.to(device)
    dev = next(model.parameters()).device
    if balances is None:
        balances = initial_balances(num_stages)
    return TrainState(
        model=model,
        optimizer=build_optimizer(optim_cfg, model),
        ema={k: v.detach().clone() for k, v in model.state_dict().items()},
        ema_count=0.0,
        balances=torch.as_tensor(balances, dtype=torch.float32).to(dev).clone(),
    )


def resize_batch(img: torch.Tensor, ann: torch.Tensor, resize_to, base_hw):
    """Multi-scale resize of a collated batch: (B, H, W, 3) float pixels ->
    ``resize_to`` by bilinear interpolation (half-pixel centres, no
    antialias), targets' boxes scaled by max(resize_to) / max(base_hw)."""
    scale = float(max(resize_to)) / float(max(base_hw))
    out = F.interpolate(img.permute(0, 3, 1, 2), size=tuple(resize_to), mode="bilinear",
                        align_corners=False, antialias=False).permute(0, 2, 3, 1)
    return out, torch.cat([ann[..., :4] * scale, ann[..., 4:]], dim=-1)


def make_train_step(loss, anchors=None, accumulate: int = 1, do_ema: bool = True,
                    resize_to=None, base_hw=None, compute_dtype=torch.float32,
                    collective=None) -> Callable:
    """Build the train step ``(state, batch) -> (state, metrics)``.

    ``loss`` is a family loss ``loss_fn(preds, targets, balances) ->
    (loss_dict, new_balances)`` or a ``YOLOv5LossConfig`` paired with
    ``anchors``. ``batch`` = {'img': uint8 (k*B, H, W, 3), 'ann': float32
    (k*B, M, 6)} on the model's device, k = ``accumulate``. ``resize_to`` /
    ``base_hw``: multi-scale training, the batch resized on the device (see
    ``resize_batch``); the loss must be built at ``resize_to``.
    ``compute_dtype``: the image is cast to it before the /255 (and before a
    resize), as in the JAX package; build the model with the same ``dtype``.
    Activation rematerialization is a model knob (``remat=True``), as there.

    ``metrics`` holds the mean over micro-batches of the loss dict and
    ``grad_norm``, the global norm of the averaged gradient before clipping,
    as 0-dim tensors on the device: nothing is read back here.

    ``collective``: data parallelism (``train/ddp.py``), which reduces the
    averaged gradients, the metrics and the balances over the ranks before
    the optimizer update.

    The first call at each input shape runs in the span ``warmup.train_step``
    (cuDNN's autotune, the allocator's growth), each phase of an update in a
    ``train.*`` span (``utils/trace.py``)."""
    if isinstance(loss, YOLOv5LossConfig):
        cfg, anchors_t = loss, torch.as_tensor(anchors, dtype=torch.float32)

        def family_loss(preds, targets, balances):
            return yolov5_loss(preds, targets, anchors_t, balances, cfg)
    else:
        family_loss = loss

    seen = set()  # (shape, dtype) of the images of the steps so far

    def train_step(state: TrainState, batch):
        img = batch["img"]
        with warmup("warmup.train_step", seen, (tuple(img.shape), img.dtype)):
            return _step(state, batch)

    def _step(state: TrainState, batch):
        k = accumulate
        model = state.model
        model.train()
        img, ann = batch["img"], batch["ann"]
        if resize_to is not None and tuple(img.shape[1:3]) != tuple(resize_to):
            img, ann = resize_batch(img.to(compute_dtype), ann, resize_to, base_hw)
        micro_b = img.shape[0] // k
        for p in model.parameters():
            p.grad = None
        balances = state.balances
        history = []
        for i in range(k):
            sl = slice(i * micro_b, (i + 1) * micro_b)
            with span("train.forward"):
                x = img[sl].to(compute_dtype) / 255.0
                preds = model(x.permute(0, 3, 1, 2).contiguous())
            with span("train.loss"):
                loss_dict, balances = family_loss(preds, ann[sl], balances)
            with span("train.backward"):
                loss_dict["tot_loss"].backward()
            history.append({n: v.detach() for n, v in loss_dict.items()})
        with span("train.optimizer"):
            grads = [p.grad for p in state.optimizer.params() if p.grad is not None]
            if k > 1:
                torch._foreach_div_(grads, float(k))
            if collective is not None:
                collective.grads(grads)
                balances = collective.balances(balances)
            grad_norm = state.optimizer.step()
        if do_ema:
            with span("train.ema"):
                state.ema_count += 1.0
                ema_update(state.ema, model.state_dict(), state.ema_count)
        state.balances = balances.detach()
        state.step += 1
        metrics = {n: torch.stack([h[n] for h in history]).mean() for n in history[0]}
        if collective is not None:
            metrics = collective.metrics(metrics)
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step
