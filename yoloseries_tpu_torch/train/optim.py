"""Optimizer: three parameter groups, warmup and epoch schedules, global-norm
clipping; a plain PyTorch counterpart of ``yoloseries_tpu/train/optim.py``
(optax ``chain(clip_by_global_norm, multi_transform({...}))``).

* Groups as the JAX package's leaf names sort them: the scales of
  BatchNorm and GroupNorm and FCOS's ``Scale`` (flax leaves ``scale``) go
  to ``"other"``, every ``.bias`` (norms and biased convs alike) to
  ``"bias"``, conv kernels and YOLOv7's implicit priors to ``"weight"``, the
  only group with weight decay.
* Clipping as optax's ``clip_by_global_norm``: no eps, no clamp; the
  gradient is scaled by ``max_norm / norm`` only when ``norm >= max_norm``.
* Per group and update: weight decay added to the clipped gradient, then
  SGD with a Nesterov trace that starts at zero (``trace = g + m * trace``,
  update ``g + m * trace``) or Adam (optax's moments, bias correction and
  ``eps`` outside the square root), then ``p -= lr * update``.
* lr and momentum are evaluated at each group's own update count, from 0,
  with the reference's warmup write-and-hold (see ``_group_schedule``), in
  float32 as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

__all__ = ["OptimizerConfig", "Optimizer", "build_optimizer", "lr_schedule_factor",
           "param_group_label", "GROUPS"]

GROUPS = ("weight", "other", "bias")
_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    optimizer: str = "sgd"  # 'sgd' | 'adam'
    basic_lr_per_img: float = 0.000625
    batch_size: int = 64  # global batch; lr = basic_lr_per_img * batch_size
    weight_decay: float = 0.0001
    momentum: float = 0.937
    scheduler_type: str = "linear"  # 'linear' | 'cosine' | 'onecycle'
    lr_max_ds_scale: float = 0.001
    total_epochs: int = 300
    steps_per_epoch: int = 1000
    do_warmup: bool = True
    warmup_epochs: int = 3
    warmup_bias_max_lr: float = 0.1
    warmup_momentum: float = 0.8
    clip_grad_norm: float = 10.0
    # exact warmup length in updates; None -> max(warmup_epochs * spe, 1000)
    warmup_steps_override: int | None = None

    @property
    def lr(self) -> float:
        return self.basic_lr_per_img * self.batch_size

    @property
    def warmup_steps(self) -> int:
        if not self.do_warmup:
            return 0
        if self.warmup_steps_override is not None:
            return self.warmup_steps_override
        return max(self.warmup_epochs * self.steps_per_epoch, 1000)


def lr_schedule_factor(cfg: OptimizerConfig, epoch):
    """Per-epoch decay factor (float32)."""
    epoch = _f32(epoch)
    t = cfg.scheduler_type.lower()
    if t == "onecycle":
        return ((_f32(1.0) - np.cos(epoch * _f32(math.pi) / _f32(cfg.total_epochs))) / _f32(2.0)
                ) * _f32(cfg.lr_max_ds_scale - 1.0) + _f32(1.0)
    if t == "linear":
        # max(total - 1, 1): a one-epoch run trains at factor ~1, not NaN
        return (_f32(1.0) - epoch / _f32(max(cfg.total_epochs - 1, 1))) * _f32(
            1.0 - cfg.lr_max_ds_scale) + _f32(cfg.lr_max_ds_scale)
    return ((_f32(1.0) + np.cos(epoch * _f32(math.pi) / _f32(cfg.total_epochs))) / _f32(2.0)
            ) * _f32(1.0 - cfg.lr_max_ds_scale) + _f32(cfg.lr_max_ds_scale)


def _group_schedule(cfg: OptimizerConfig, warmup_start: float):
    """Update count (from 0) -> lr: the warmup interpolation, then the
    epoch factor.

    The reference counts updates from t = 1 and, during warmup (t < W),
    writes the group's lr each update; nothing rewrites it before the next
    epoch boundary. So after warmup ends mid-epoch, the value written at
    t = W - 1 holds for the rest of that epoch (for the bias group, far
    above the base lr): the interpolation is clamped at W - 1 and kept while
    the last warmup write is more recent than the last epoch boundary."""

    def schedule(step) -> float:
        step = _f32(step)
        epoch = np.floor(step / _f32(cfg.steps_per_epoch))
        base = _f32(cfg.lr) * lr_schedule_factor(cfg, epoch)
        w = _f32(cfg.warmup_steps)
        if w > 0:
            t = step + _f32(1.0)
            t_eff = min(t, w - _f32(1.0))
            frac = np.clip(t_eff / w, _f32(0.0), _f32(1.0))
            warm = _f32(warmup_start) + _f32(cfg.lr - warmup_start) * frac
            live = (t < w) or ((w - _f32(1.0)) > _f32(cfg.steps_per_epoch) * epoch)
            return float(warm if live else base)
        return float(base)

    return schedule


def _momentum_schedule(cfg: OptimizerConfig):
    """Update count -> SGD momentum. The reference writes the momentum only
    during warmup and never after: the value written at t = W - 1 holds for
    the rest of training. W < 2 never writes: the constructor's momentum."""

    def schedule(step) -> float:
        w = _f32(cfg.warmup_steps)
        if w >= 2:
            t = _f32(step) + _f32(1.0)
            t_eff = min(t, w - _f32(1.0))
            frac = np.clip(t_eff / w, _f32(0.0), _f32(1.0))
            return float(_f32(cfg.warmup_momentum)
                         + _f32(cfg.momentum - cfg.warmup_momentum) * frac)
        return float(_f32(cfg.momentum))

    return schedule


def param_group_label(module: nn.Module, name: str) -> str:
    """'bias' for every bias, 'other' for a BatchNorm or GroupNorm scale and
    a ``Scale``'s scalar, 'weight' for the rest (conv kernels, implicit
    priors)."""
    if name == "bias":
        return "bias"
    if name == "scale" or (name == "weight" and isinstance(
            module, (nn.modules.batchnorm._BatchNorm, nn.GroupNorm))):
        return "other"
    return "weight"


def _grouped_params(model: nn.Module) -> dict:
    groups = {g: [] for g in GROUPS}
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            groups[param_group_label(module, name)].append(p)
    return groups


class Optimizer:
    """The three groups' update, with explicit per-group state.

    ``step()`` reads each parameter's ``.grad``, clips over all of them,
    updates the parameters in place and returns the global norm before
    clipping (a 0-dim tensor on the parameters' device; no host sync)."""

    def __init__(self, cfg: OptimizerConfig, model: nn.Module):
        kind = cfg.optimizer.lower()
        if kind not in ("sgd", "adam"):
            raise ValueError(f"unknown optimizer {cfg.optimizer}")
        self.cfg = cfg
        self.kind = kind
        self.groups = _grouped_params(model)
        bias_start = cfg.warmup_bias_max_lr if cfg.do_warmup else 0.0
        self.lr_schedules = {"weight": _group_schedule(cfg, 0.0),
                             "other": _group_schedule(cfg, 0.0),
                             "bias": _group_schedule(cfg, bias_start)}
        self.momentum_schedule = _momentum_schedule(cfg)
        self.decay = {"weight": cfg.weight_decay, "other": 0.0, "bias": 0.0}
        self.counts = {g: 0 for g in GROUPS}
        self.state = {g: self._init_state(ps) for g, ps in self.groups.items()}

    def _init_state(self, params):
        zeros = [torch.zeros_like(p) for p in params]
        if self.kind == "sgd":
            return {"trace": zeros}
        return {"mu": zeros, "nu": [torch.zeros_like(p) for p in params]}

    def params(self):
        return [p for g in GROUPS for p in self.groups[g]]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        params = [p for p in self.params() if p.grad is not None]
        grads = [p.grad for p in params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        coef = torch.where(norm < self.cfg.clip_grad_norm, 1.0, self.cfg.clip_grad_norm / norm)
        torch._foreach_mul_(grads, coef)
        for g in GROUPS:
            ps = [p for p in self.groups[g] if p.grad is not None]
            if ps:
                self._group_step(g, ps)
            self.counts[g] += 1
        return norm

    def _group_step(self, g, ps):
        count = self.counts[g]
        lr = self.lr_schedules[g](count)
        grads = [p.grad for p in ps]
        if self.decay[g] > 0:
            grads = torch._foreach_add(grads, ps, alpha=self.decay[g])
        ids = {id(p) for p in ps}
        st = self.state[g]
        pick = [i for i, p in enumerate(self.groups[g]) if id(p) in ids]
        if self.kind == "sgd":
            m = self.momentum_schedule(count)
            trace = [st["trace"][i] for i in pick]
            torch._foreach_mul_(trace, m)
            torch._foreach_add_(trace, grads)  # trace = g + m * trace
            upd = torch._foreach_add(grads, trace, alpha=m)  # nesterov: g + m * trace
        else:
            b1, b2, eps = self.cfg.momentum, 0.999, 1e-8
            mu = [st["mu"][i] for i in pick]
            nu = [st["nu"][i] for i in pick]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(grads, grads), alpha=1.0 - b2)
            n = count + 1
            bc1 = float(_f32(1.0) - _f32(b1) ** _f32(n))
            bc2 = float(_f32(1.0) - _f32(b2) ** _f32(n))
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_add_(ps, upd, alpha=-lr)

    def state_dict(self) -> dict:
        return {"counts": dict(self.counts),
                "state": {g: {k: [t.clone() for t in v] for k, v in s.items()}
                          for g, s in self.state.items()}}

    def load_state_dict(self, sd: dict) -> None:
        self.counts = dict(sd["counts"])
        for g, s in sd["state"].items():
            for k, v in s.items():
                for dst, src in zip(self.state[g][k], v):
                    dst.copy_(src)


def build_optimizer(cfg: OptimizerConfig, model: nn.Module) -> Optimizer:
    return Optimizer(cfg, model)
