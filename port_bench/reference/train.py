"""The plain reference of a training update, and the batches it reads.

* ``batch``: the n-th batch of the train loader with augmentation closed,
  worked out from the image files: the seeded order (one
  ``np.random.default_rng(seed).permutation`` of the set after another),
  each image decoded with PIL and placed at the top left of a zero canvas
  of the input size (the image cache's canvas; every image here already
  fits, at a scale of 1), its boxes from the label file (sides under 1 px
  dropped, then the loader's box filter) with the class and the row in the
  batch, padded with -1. A sample whose every box the filter drops would be
  resampled by the loader; the set is drawn so that none is, and the
  reference raises if one were. With augmentation on, ``render.py``
  renders the program's plans instead.
* ``update``: one optimizer update over ``accumulate`` micro-batches: the
  train-mode forward of ``models.py`` (BN on batch statistics, which it
  also moves the running statistics towards), the family's loss
  (``families/<family>.py::loss``), gradients by autograd, summed and divided by
  the micro-batch count; then SGD as the preset states it: clipping at the
  global norm, the three groups (conv weights with weight decay; BN
  scales; every bias), Nesterov momentum, and the warmup's write-and-hold
  schedules in f32 (a frozen copy of the port's ``train/optim.py``
  schedules); then the recipe's EMA of every floating entry of the state,
  parameters and running statistics, at the decay
  ``0.9999 (1 - exp(-n / 2000))`` after the n-th update.
* ``leaf_gap``: the widest gap over the leaves between two sets of leaf
  norms, each against the larger of its reference norm and the median
  reference norm.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from . import models
from .families import family

_f32 = np.float32


# --------------------------------------------------------------- batches

def order(n_images: int, seed: int, count: int) -> list[int]:
    """The first ``count`` image indices the loader draws."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        out += rng.permutation(n_images).tolist()
    return out[:count]


def batch(img_dir, lab_dir, seed: int, n: int, size: int, batch_size: int, max_labels: int):
    """(images (B, size, size, 3) uint8, ann (B, max_labels, 6) f32)."""
    from PIL import Image

    files = sorted(p for p in Path(img_dir).iterdir() if p.suffix.lower() == ".jpg")
    idx = order(len(files), seed, (n + 1) * batch_size)[n * batch_size:]
    imgs = np.zeros((batch_size, size, size, 3), np.uint8)
    ann = np.full((batch_size, max_labels, 6), -1.0, np.float32)
    for row, i in enumerate(idx):
        img = np.asarray(Image.open(files[i]).convert("RGB"))
        h, w = img.shape[:2]
        if min(size / h, size / w) != 1.0:
            raise ValueError(f"{files[i].name}: {h}x{w} does not fit {size} at scale 1")
        imgs[row, :h, :w] = img
        lab = np.loadtxt(Path(lab_dir) / f"{files[i].stem}.txt", dtype=np.float32, ndmin=2)
        lab = lab[np.all(lab[:, 3:5] - lab[:, 1:3] >= 1, axis=1)]
        lab = lab[box_filter(lab[:, 1:5])][:max_labels]
        if not len(lab):
            raise ValueError(f"{files[i].name}: no box passes the filter (the loader resamples)")
        ann[row, :len(lab), :4] = lab[:, 1:5]
        ann[row, :len(lab), 4] = lab[:, 0]
        ann[row, :len(lab), 5] = row
    return imgs, ann


def box_filter(boxes):
    """The loader's filter of a sample's boxes (YOLOv5's box candidates):
    each side over 2 px, the area at least 16, the aspect ratio under 10."""
    w, h = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    ar = np.maximum(w / (h + 1e-16), h / (w + 1e-16))
    return (w > 2) & (h > 2) & (w * h >= 16) & (ar < 10)


# ------------------------------------------------------------ optimizer

def group_of(key: str) -> str:
    if key.endswith(".bias"):
        return "bias"
    return "other" if key.endswith(".bn.weight") else "weight"


def lr_schedule_factor(o, epoch):
    epoch = _f32(epoch)
    if o["scheduler_type"] != "linear":
        raise ValueError(f"scheduler {o['scheduler_type']!r}: the reference has 'linear'")
    return (_f32(1.0) - epoch / _f32(max(o["total_epochs"] - 1, 1))) * _f32(
        1.0 - o["lr_max_ds_scale"]) + _f32(o["lr_max_ds_scale"])


def lr_at(o, step, warmup_start):
    step = _f32(step)
    lr = o["basic_lr_per_img"] * o["batch_size"]
    epoch = np.floor(step / _f32(o["steps_per_epoch"]))
    base = _f32(lr) * lr_schedule_factor(o, epoch)
    w = _f32(o["warmup_steps"])
    t = step + _f32(1.0)
    t_eff = min(t, w - _f32(1.0))
    frac = np.clip(t_eff / w, _f32(0.0), _f32(1.0))
    warm = _f32(warmup_start) + _f32(lr - warmup_start) * frac
    live = (t < w) or ((w - _f32(1.0)) > _f32(o["steps_per_epoch"]) * epoch)
    return float(warm if live else base)


def momentum_at(o, step):
    w = _f32(o["warmup_steps"])
    t = _f32(step) + _f32(1.0)
    t_eff = min(t, w - _f32(1.0))
    frac = np.clip(t_eff / w, _f32(0.0), _f32(1.0))
    return float(_f32(o["warmup_momentum"]) + _f32(o["momentum"] - o["warmup_momentum"]) * frac)


class SGD:
    """The three groups' Nesterov SGD; ``trace`` is each leaf's momentum
    trace (after one update: the clipped gradient plus weight decay, the
    gradient as the optimizer takes it)."""

    def __init__(self, params: dict, o: dict):
        self.params, self.o, self.step_count = params, o, 0
        self.trace = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict):
        o = self.o
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
        coef = torch.where(norm < o["clip_grad_norm"], 1.0, o["clip_grad_norm"] / norm)
        lr = {"weight": lr_at(o, self.step_count, 0.0), "other": lr_at(o, self.step_count, 0.0),
              "bias": lr_at(o, self.step_count, o["warmup_bias_max_lr"])}
        m = momentum_at(o, self.step_count)
        for k, p in self.params.items():
            g = grads[k] * coef
            if group_of(k) == "weight":
                g = g + p * o["weight_decay"]
            self.trace[k].mul_(m).add_(g)
            p.sub_(lr[group_of(k)] * (g + m * self.trace[k]))
        self.step_count += 1


# --------------------------------------------------------------- update

def family_loss(cfg: dict, hyp: dict, size: int, device):
    """(loss(maps, ann, balances) -> (loss dict, new balances), the initial
    balances) of the configuration's family."""
    return family(cfg).loss(cfg, hyp, size, device)


def update(sd: dict, params: dict, opt: SGD, cfg: dict, loss, imgs, ann, balances,
           accumulate: int, keep=None):
    """One update in place on ``params`` and on the running statistics in
    ``sd``; returns (mean loss, new balances). ``keep``: the rows of each
    micro-batch that count (all by default)."""
    mb = imgs.shape[0] // accumulate
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    losses = []
    for i in range(accumulate):
        sl = slice(i * mb, (i + 1) * mb)
        x, a = imgs[sl], ann[sl]
        if keep is not None:
            x, a = x[keep], a[keep]
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        maps = models.forward({**sd, **leaves}, (x.float() / 255.0).permute(0, 3, 1, 2)
                              .contiguous(), cfg, mode="train")
        loss_dict, balances = loss(maps, a, balances)
        for k, g in zip(leaves, torch.autograd.grad(loss_dict["tot_loss"], list(leaves.values()))):
            grads[k] += g
        losses.append(float(loss_dict["tot_loss"].detach()))
        balances = balances.detach()
    for g in grads.values():
        g /= accumulate
    opt.step(grads)
    return sum(losses) / len(losses), balances


@torch.no_grad()
def ema_step(ema: dict, state: dict, n: int, ratio: float = 0.9999):
    """The EMA after the n-th update: ``d ema + (1 - d) state`` in every
    floating entry, ``d = ratio (1 - exp(-n / 2000))``."""
    d = ratio * (1.0 - math.exp(-n / 2000.0))
    for k, v in ema.items():
        if v.is_floating_point():
            v.mul_(d).add_(state[k], alpha=1.0 - d)


def leaf_gap(got: dict, want: dict, keys=None) -> tuple[float, str]:
    """The widest |norm(got) - norm(want)| over the leaves, each over
    max(norm(want), the median norm(want)); and that leaf's name."""
    keys = list(want) if keys is None else list(keys)
    ref = {k: float(want[k].norm()) for k in keys}
    med = float(np.median(list(ref.values())))
    worst, name = 0.0, ""
    for k in keys:
        gap = abs(float(got[k].norm()) - ref[k]) / max(ref[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, name = gap, k
    return worst, name
