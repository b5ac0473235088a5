"""Greedy NMS: the CUDA kernel ``csrc/nms_greedy.cu`` and its plain
PyTorch twins.

Replaces ``yoloseries_tpu/kernels/nms_pallas.py::pallas_greedy_nms``.
Contract: boxes (B, K, 4) f32 xyxy with any class offset already added,
scores (B, K) f32 in any order with 0 marking dead slots, K <= 8192;
returns ``keep_idx`` (B, max_keep) int32 padded with -1 and ``keep_valid``
(B, max_keep) bool. Suppression at IoU >= thr, ties to the lower index, the
keeper zeroed explicitly (a zero-area box has self-IoU 0).

``greedy_nms`` is the argmax loop of the contract; ``greedy_nms_tiled_plain``
is the kernel's design step for step (priority order, 32-wide tiles in
order, each member tested against the keepers so far, then resolved inside
its tile), for the tests: the two give the same result. ``nms_greedy``
runs ``greedy_nms`` for a tensor on the CPU and the kernel for a tensor on
a CUDA device; ``nms_greedy.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ..ops.iou import pairwise_iou
from . import _build

__all__ = ["GREEDY_MAX_K", "greedy_nms", "greedy_nms_tiled_plain", "nms_greedy",
           "priority_order"]

GREEDY_MAX_K = 8192  # shared memory at K = 8192: sort keys 64 KB + planes 160 KB


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               max_keep: int):
    """Plain greedy NMS, (K, 4)/(K,) or batched (B, K, 4)/(B, K).

    Each step takes the leftmost argmax of the live scores; a best score
    <= 0 ends the image (every later slot stays -1 / False)."""
    single = scores.dim() == 1
    if single:
        boxes, scores = boxes[None], scores[None]
    boxes = boxes.float()
    live = scores.float().clone()
    b = live.shape[0]
    rows = torch.arange(b, device=live.device)
    keep_idx = torch.full((b, max_keep), -1, dtype=torch.int32, device=live.device)
    keep_valid = torch.zeros((b, max_keep), dtype=torch.bool, device=live.device)
    for slot in range(max_keep):
        idx = live.argmax(dim=1)  # first maximal value: lowest index on ties
        valid = live[rows, idx] > 0.0
        if not bool(valid.any()):
            break
        suppress = pairwise_iou(boxes[rows, idx][:, None], boxes)[:, 0] >= iou_threshold
        live = torch.where(valid[:, None] & suppress, 0.0, live)
        live[rows, idx] = 0.0  # zero the keeper explicitly
        keep_idx[:, slot] = torch.where(valid, idx.to(torch.int32), -1)
        keep_valid[:, slot] = valid
    if single:
        return keep_idx[0], keep_valid[0]
    return keep_idx, keep_valid


def priority_order(scores: torch.Tensor) -> torch.Tensor:
    """(B, K) int64: the candidates in greedy's order, score descending and
    ties to the lower index; the live ones (score > 0) come first."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


def greedy_nms_tiled_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                           max_keep: int, tile: int = 32):
    """The kernel's design in plain PyTorch, batched (B, K, 4)/(B, K).

    The candidates in priority order, cut into ``tile``-wide tiles. Tile by
    tile: the live members that no keeper so far suppresses (pull), then
    each of them kept unless a kept earlier member of the tile suppresses it
    (serially, up to max_keep). Same result as ``greedy_nms``."""
    boxes, scores = boxes.float(), scores.float()
    b, k = scores.shape
    dev = scores.device
    order = priority_order(scores)
    ob = torch.take_along_dim(boxes, order[..., None], dim=1)
    live = torch.take_along_dim(scores, order, dim=1) > 0.0
    keep_idx = torch.full((b, max_keep), -1, dtype=torch.int32, device=dev)
    keep_valid = torch.zeros((b, max_keep), dtype=torch.bool, device=dev)
    keep_box = torch.zeros((b, max_keep, 4), device=dev)
    count = torch.zeros(b, dtype=torch.int64, device=dev)
    ids = torch.arange(max(tile, max_keep), device=dev)
    for start in range(0, k, tile):
        stop = min(start + tile, k)
        n = stop - start
        alive = live[:, start:stop] & (count < max_keep)[:, None]
        if not bool(alive.any()):
            continue
        tb = ob[:, start:stop]
        pulled = (pairwise_iou(keep_box, tb) >= iou_threshold) & (ids[:max_keep, None]
                                                                 < count[:, None, None])
        alive &= ~pulled.any(dim=1)
        # [b, j, l]: live member j, earlier in the tile, suppresses member l
        sup = ((pairwise_iou(tb, tb) >= iou_threshold) & (ids[:n, None] < ids[None, :n])
               & alive[:, :, None])
        kept = torch.zeros_like(alive)
        for l in range(n):
            blocked = (sup[:, :, l] & kept).any(dim=1)
            kept[:, l] = alive[:, l] & ~blocked & (count + kept.sum(dim=1) < max_keep)
        slot = count[:, None] + kept.cumsum(dim=1) - 1
        rows, cols = kept.nonzero(as_tuple=True)
        keep_idx[rows, slot[rows, cols]] = order[rows, start + cols].to(torch.int32)
        keep_valid[rows, slot[rows, cols]] = True
        keep_box[rows, slot[rows, cols]] = tb[rows, cols]
        count += kept.sum(dim=1)
    return keep_idx, keep_valid


def check_nms_inputs(boxes: torch.Tensor, scores: torch.Tensor, max_k: int,
                     name: str) -> None:
    """Raise on inputs an NMS kernel does not take."""
    if scores.dim() != 2 or boxes.shape != (*scores.shape, 4):
        raise ValueError(f"{name}: want boxes (B, K, 4) and scores (B, K), got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"{name}: boxes and scores must be float32")
    if boxes.device != scores.device:
        raise ValueError(f"{name}: boxes and scores on different devices")
    if not 1 <= scores.shape[1] <= max_k:
        raise ValueError(f"{name}: K={scores.shape[1]} outside 1..{max_k}")


def check_cuda_inputs(entry: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{entry}: tensors must be on the CPU or a CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{entry}: tensors must be contiguous")


def launch_nms(entry: str, wrapper, boxes: torch.Tensor, scores: torch.Tensor,
               iou_threshold: float, max_keep: int, scratch: torch.Tensor | None = None):
    """Allocate the outputs, launch C entry ``entry`` on the current stream
    (with the device ``scratch`` after the outputs, where it takes one) and
    count the launch on ``wrapper.launches`` (inputs already checked)."""
    check_cuda_inputs(entry, boxes, scores)
    b, k = scores.shape
    keep_idx = torch.empty((b, max_keep), dtype=torch.int32, device=boxes.device)
    keep_valid = torch.empty((b, max_keep), dtype=torch.bool, device=boxes.device)
    if b == 0 or max_keep == 0:
        return keep_idx, keep_valid
    extra = () if scratch is None else (scratch.data_ptr(),)
    _build.launch(entry, boxes.device, boxes.data_ptr(), scores.data_ptr(), b, k,
                  float(iou_threshold), max_keep, keep_idx.data_ptr(),
                  keep_valid.data_ptr(), *extra)
    wrapper.launches += 1
    return keep_idx, keep_valid


def nms_greedy(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               max_keep: int = 300):
    """Batched greedy NMS, input in any order: the CUDA kernel on a CUDA
    tensor, ``greedy_nms`` on a CPU tensor. Returns (keep_idx (B, max_keep)
    int32, keep_valid bool)."""
    check_nms_inputs(boxes, scores, GREEDY_MAX_K, "nms_greedy")
    if boxes.device.type == "cpu":
        return greedy_nms(boxes, scores, iou_threshold, max_keep)
    return launch_nms("yst_nms_greedy", nms_greedy, boxes, scores,
                      iou_threshold, max_keep)


nms_greedy.launches = 0
