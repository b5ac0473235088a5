"""Data parallelism on ``torch.distributed``; counterpart of
``yoloseries_tpu/parallel/mesh.py``.

JAX runs one process per host over a ('data',) mesh of its devices; the
port runs one process per card, as ``torchrun`` starts them:

    torchrun --nproc_per_node N -m yoloseries_tpu_torch.cli.train ...

* ``init_from_env`` reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``; or ``DIST_INIT_METHOD``,
  for example ``file:///tmp/rendezvous``, in place of the address) and
  initialises the default process group: NCCL when the rank runs on a card,
  gloo on the CPU (a caller that wants another backend initialises the group
  itself first). Rank r runs on
  ``cuda:LOCAL_RANK`` (modulo the cards it sees, so that gloo ranks may
  share one card; NCCL refuses two ranks on one card). Without that
  environment, or with a world of 1, no group is made: one process is the
  identity path.
* ``process_index``/``process_count``: the rank and the world, 0 and 1
  without a group.
* ``all_reduce_sum``/``all_reduce_mean`` over the default group, the
  identity without one.
* Batch semantics (``part_rows``): the port's ``batch_size`` is the global
  batch of one update, split evenly over the ranks. The global-batch path
  gives rank r the r-th contiguous part of each micro-batch of the batch
  that one process would load, the per-replica path the r-th contiguous
  part of the whole batch (JAX's ``shard_map`` split). ``shard_range``
  gives each rank a contiguous part of the val set.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["init_from_env", "is_distributed", "process_index", "process_count",
           "all_reduce_sum", "all_reduce_mean", "sum_over_ranks", "part_rows", "shard_range"]


def init_from_env(device=None) -> torch.device:
    """Initialise the default process group from the environment when it
    names more than one rank and none is initialised yet; returns this
    rank's device (``device``'s type, ``cuda`` by default; a card is an
    error to ask for without one)."""
    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if world > 1 and not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=os.environ.get("DIST_INIT_METHOD", "env://"),
            world_size=world, rank=int(os.environ["RANK"]))
    return dev


def is_distributed() -> bool:
    """True inside an initialised group of more than one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks, in place; the identity on one process."""
    if is_distributed():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """Mean over the ranks, in place; the identity on one process."""
    if is_distributed():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        t.div_(dist.get_world_size())
    return t


class _SumOverRanks(torch.autograd.Function):
    """The sum over the ranks of the default group; its gradient is the sum
    over the ranks of the gradients that reach it."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """``all_reduce_sum`` that autograd differentiates (a new tensor)."""
    return _SumOverRanks.apply(x)


def part_rows(n: int, rank: int, world: int, groups: int = 1) -> np.ndarray:
    """Positions of rank ``rank``'s rows in a batch of ``n``: the
    ``rank``-th contiguous part of each of ``groups`` equal groups, in
    group order. Raises unless the parts divide evenly."""
    if n % (groups * world):
        raise ValueError(f"a batch of {n} does not split into {groups} group(s) over "
                         f"{world} ranks")
    size, part = n // groups, n // (groups * world)
    return np.concatenate([np.arange(g * size + rank * part, g * size + (rank + 1) * part)
                           for g in range(groups)])


def shard_range(n: int, batch_size: int, rank: int, world: int) -> tuple:
    """(start, stop) of rank ``rank``'s contiguous part of a set of ``n``:
    whole batches of ``batch_size`` each, the same count on every rank, in
    rank order (the last partial batches dropped, as a finite loader
    drops them)."""
    per_rank = (n // (batch_size * world)) * batch_size
    return rank * per_rank, (rank + 1) * per_rank
