"""Data-parallel train steps on ``torch.distributed``; counterpart of
``yoloseries_tpu/train/ddp.py`` and of the JAX ``Trainer``'s pjit path.

Every rank holds the same parameters, optimizer state, EMA and balances
(the same seeded initial weights; the same reduced update each step). Two
steps, as in the JAX package:

* **the global batch** (the default, JAX's pjit step over a sharded batch):
  one function of the whole batch. BN takes its statistics over the global
  batch (``set_sync_bn``: the port's ``nn/layers.py::BatchNorm`` all-reduces
  its per-channel sums; ``nn.SyncBatchNorm`` would not keep its eps and
  eval arithmetic), the loss's global terms are summed over the ranks (the
  family's ``make_loss(..., reduce=all_reduce_sum)``: the batch, the
  positives, the balance update), each rank's loss is its share of the
  global loss, and the gradients (``GlobalBatch``) and the logged shares are
  summed. Only YOLOv5's loss reduces its terms so far (ROADMAP A8b).
* **per replica** (``per_replica_bn: true``, JAX's ``make_ddp_train_step``
  under ``shard_map``; the reference's DDP): each rank's BN statistics, the
  running ones and their EMA, follow its own part of the batch; the
  gradients, the loss dict and the balances are averaged over the ranks
  (``PerReplica``: JAX's ``pmean``s), and ``sync_replica_stats`` averages
  the running statistics before an evaluation.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import BatchNorm
from ..parallel.dist import all_reduce_mean, all_reduce_sum

__all__ = ["GlobalBatch", "PerReplica", "set_sync_bn", "sync_replica_stats"]


def _reduce_flat(tensors: list, reduce) -> None:
    """Reduce a list of tensors in place through one flat buffer."""
    if not tensors:
        return
    flat = reduce(torch.cat([t.reshape(-1) for t in tensors]))
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _reduce_metrics(metrics: dict, reduce) -> dict:
    names = sorted(metrics)
    flat = reduce(torch.stack([metrics[n].float() for n in names]))
    return dict(zip(names, flat.unbind()))


class GlobalBatch:
    """The collective of the global-batch step: each rank's gradient and
    logged loss terms are its share of the global ones, so they are summed;
    the balances are global already."""

    @staticmethod
    def grads(grads: list) -> None:
        _reduce_flat(grads, all_reduce_sum)

    @staticmethod
    def balances(balances: torch.Tensor) -> torch.Tensor:
        return balances

    @staticmethod
    def metrics(metrics: dict) -> dict:
        return _reduce_metrics(metrics, all_reduce_sum)


class PerReplica:
    """The collective of the per-replica step: means over the ranks."""

    @staticmethod
    def grads(grads: list) -> None:
        _reduce_flat(grads, all_reduce_mean)

    @staticmethod
    def balances(balances: torch.Tensor) -> torch.Tensor:
        return all_reduce_mean(balances.detach().clone())

    @staticmethod
    def metrics(metrics: dict) -> dict:
        return _reduce_metrics(metrics, all_reduce_mean)


def set_sync_bn(model: nn.Module, on: bool = True) -> nn.Module:
    """Make every ``BatchNorm`` of ``model`` take its training statistics
    over the global batch of the default group's ranks (``on=False``: its
    own batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.global_batch = on
    return model


def sync_replica_stats(state_dict: dict) -> dict:
    """A copy of ``state_dict`` with every BN running mean and variance
    averaged over the ranks: the pre-evaluation sync of per-replica BN (JAX
    ``sync_replica_stats``; the reference's ``all_reduce_norm``)."""
    out = dict(state_dict)
    keys = [k for k in out if k.endswith(("running_mean", "running_var"))]
    stats = [out[k].detach().clone() for k in keys]
    _reduce_flat(stats, all_reduce_mean)
    out.update(zip(keys, stats))
    return out
