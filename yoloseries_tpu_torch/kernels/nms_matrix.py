"""Matrix NMS: the CUDA kernel ``csrc/nms_matrix.cu``, its plain PyTorch
twin, and the strip-chunked driver for K > 1024.

Replaces ``yoloseries_tpu/kernels/nms_matrix.py::pallas_matrix_nms`` (B2)
and ``pallas_matrix_nms_chunked`` (B3). Same contract as
``nms_greedy.nms_greedy`` and the same result (exact greedy NMS, keepers in
priority order); the input need not be sorted. B2 takes K <= 1024.

``matrix_nms`` runs the twin for a tensor on the CPU and the kernel for a
tensor on a CUDA device; ``matrix_nms.launches`` counts kernel launches.
``matrix_nms_chunked`` is torch code over ``matrix_nms``; its
``launches`` counts its runs on a CUDA device.
"""

from __future__ import annotations

import torch

from ..ops.iou import pairwise_iou
from .nms_greedy import check_nms_inputs, launch_nms

__all__ = ["MATRIX_MAX_K", "matrix_nms", "matrix_nms_chunked", "matrix_nms_plain"]

MATRIX_MAX_K = 1024  # K x K bits of shared memory: 128 KB


def matrix_nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_threshold: float, max_keep: int):
    """Plain twin of the matrix kernel: the same confirm/kill fixpoint over
    the dense (B, J, I) suppression relation."""
    b, k = scores.shape
    dev = scores.device
    iou = pairwise_iou(boxes, boxes)  # (B, J, I): row j suppresses column i
    ids = torch.arange(k, device=dev)
    s_j, s_i = scores[:, :, None], scores[:, None, :]
    pri = (s_j > s_i) | ((s_j == s_i) & (ids[:, None] < ids[None, :]))
    sup = (iou >= iou_threshold) & pri
    undecided = scores > 0.0
    kept = torch.zeros_like(undecided)
    while bool(undecided.any()):
        blocked = (sup & undecided[:, :, None]).any(dim=1)
        kept = kept | (undecided & ~blocked)
        killed = (sup & kept[:, :, None]).any(dim=1)
        undecided = undecided & blocked & ~killed
    rank = (pri & kept[:, :, None]).sum(dim=1)  # keepers ahead of each i
    keep_idx = torch.full((b, max_keep), -1, dtype=torch.int32, device=dev)
    keep_valid = torch.zeros((b, max_keep), dtype=torch.bool, device=dev)
    rows, cols = (kept & (rank < max_keep)).nonzero(as_tuple=True)
    keep_idx[rows, rank[rows, cols]] = cols.to(torch.int32)
    keep_valid[rows, rank[rows, cols]] = True
    return keep_idx, keep_valid


def matrix_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               max_keep: int = 300):
    """Exact greedy NMS for K <= 1024: the CUDA kernel on a CUDA tensor, the
    twin on a CPU tensor."""
    check_nms_inputs(boxes, scores, MATRIX_MAX_K, "matrix_nms")
    if boxes.device.type == "cpu":
        return matrix_nms_plain(boxes, scores, iou_threshold, max_keep)
    return launch_nms("yst_nms_matrix", matrix_nms, boxes, scores,
                      iou_threshold, max_keep)


matrix_nms.launches = 0


def matrix_nms_chunked(boxes: torch.Tensor, scores: torch.Tensor,
                       iou_threshold: float, max_keep: int = 300,
                       chunk: int = MATRIX_MAX_K):
    """Exact greedy NMS at any K: stable sort by score, then ``chunk``-wide
    strips in priority order through ``matrix_nms``, each strip first losing
    the candidates that overlap a keeper carried from earlier strips. The
    carry is truncated at ``max_keep``: a later candidate's rank would pass
    it. Returns indices into the original (unsorted) candidate axis."""
    b, k = scores.shape
    if k <= chunk:
        return matrix_nms(boxes, scores, iou_threshold, max_keep)
    dev = scores.device
    pad = (-k) % chunk
    boxes = torch.nn.functional.pad(boxes.float(), (0, 0, 0, pad))
    scores = torch.nn.functional.pad(scores.float(), (0, pad))  # 0 = dead
    kp = k + pad

    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    sb = torch.take_along_dim(boxes, order[..., None], dim=1)
    ss = torch.take_along_dim(scores, order, dim=1)

    carry_box = torch.zeros((b, max_keep, 4), dtype=torch.float32, device=dev)
    carry_idx = torch.full((b, max_keep), -1, dtype=torch.int32, device=dev)
    carry_valid = torch.zeros((b, max_keep), dtype=torch.bool, device=dev)
    for c in range(kp // chunk):
        cb = sb[:, c * chunk:(c + 1) * chunk].contiguous()
        cs = ss[:, c * chunk:(c + 1) * chunk]
        if c > 0:
            killed = ((pairwise_iou(carry_box, cb) >= iou_threshold)
                      & carry_valid[..., None]).any(dim=1)
            cs = torch.where(killed, 0.0, cs)
        kidx, kval = matrix_nms(cb, cs.contiguous(), iou_threshold, max_keep)
        kidx = torch.where(kval, kidx + c * chunk, -1)
        kbox = torch.take_along_dim(sb, kidx.clamp_min(0).long()[..., None], dim=1)
        # carried keepers first, then this strip's, valid slots compacted to
        # the front in order and cut at max_keep
        all_idx = torch.cat([carry_idx, kidx], dim=1)
        all_val = torch.cat([carry_valid, kval], dim=1)
        all_box = torch.cat([carry_box, kbox], dim=1)
        compact = torch.sort((~all_val).to(torch.uint8), dim=-1, stable=True).indices
        compact = compact[:, :max_keep]
        carry_idx = torch.take_along_dim(all_idx, compact, dim=1)
        carry_valid = torch.take_along_dim(all_val, compact, dim=1)
        carry_box = torch.take_along_dim(all_box, compact[..., None], dim=1)

    orig = torch.take_along_dim(order, carry_idx.clamp_min(0).long(), dim=1)
    keep_idx = torch.where(carry_valid, orig.to(torch.int32), -1)
    if dev.type == "cuda":
        matrix_nms_chunked.launches += 1
    return keep_idx, carry_valid


matrix_nms_chunked.launches = 0
