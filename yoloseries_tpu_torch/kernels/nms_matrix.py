"""Matrix NMS on the card: the relation kernel ``csrc/nms_relation.cu``, B2
and B3 in ``csrc/nms_matrix.cu``, and their plain PyTorch twins.

Replaces ``yoloseries_tpu/kernels/nms_matrix.py::pallas_matrix_nms`` (B2)
and ``pallas_matrix_nms_chunked`` (B3). Same contract as
``nms_greedy.nms_greedy`` and the same result (exact greedy NMS, keepers in
priority order); the input need not be sorted. B2 takes K <= 1024, B3 any
K.

Each wrapper runs its twin for a tensor on the CPU and its kernels for a
tensor on a CUDA device, and counts its C calls in ``.launches``:

* ``nms_relation`` (twin ``nms_relation_plain``): the (B, W, K) suppression
  words, W = ceil(K / 32); bit l of word w of victim i says that
  j = 32 w + l suppresses i (both live, j before i, IoU >= thr);
* ``matrix_nms`` (twin ``matrix_nms_plain``, which is
  ``matrix_fixpoint_plain`` over ``nms_relation_plain``): the relation and
  the confirm/kill fixpoint, two kernels in one C call;
* ``matrix_nms_chunked`` (twin ``matrix_nms_chunked_plain``): a stable sort
  by score, then one C call that runs every ``chunk``-wide strip on the
  card with the keepers carried on the device; an image whose carry is full
  skips its later strips. No torch op runs per strip and the host never
  waits.
"""

from __future__ import annotations

import torch

from ..ops.iou import pairwise_iou
from . import _build
from .nms_greedy import check_cuda_inputs, check_nms_inputs, launch_nms, priority_order

__all__ = ["MATRIX_MAX_K", "matrix_fixpoint_plain", "matrix_nms", "matrix_nms_chunked",
           "matrix_nms_chunked_plain", "matrix_nms_plain", "nms_relation",
           "nms_relation_plain"]

MATRIX_MAX_K = 1024  # K x K bits of shared memory in the fixpoint: 128 KB


def _priority(scores: torch.Tensor) -> torch.Tensor:
    """(B, J, I) bool: j is taken before i (higher score, ties to the lower
    index)."""
    ids = torch.arange(scores.shape[1], device=scores.device)
    s_j, s_i = scores[:, :, None], scores[:, None, :]
    return (s_j > s_i) | ((s_j == s_i) & (ids[:, None] < ids[None, :]))


def nms_relation_plain(boxes: torch.Tensor, scores: torch.Tensor,
                       iou_threshold: float) -> torch.Tensor:
    """Plain twin of the relation kernel: (B, W, K) int32 words (the
    kernel's u32 bits viewed as int32), word w of victim i at [b, w, i]."""
    live = scores > 0.0
    sup = ((pairwise_iou(boxes, boxes) >= iou_threshold) & _priority(scores)
           & live[:, :, None] & live[:, None, :])  # (B, J, I): row j suppresses column i
    b, k, _ = sup.shape
    w = -(-k // 32)
    bits = torch.nn.functional.pad(sup, (0, 0, 0, 32 * w - k)).view(b, w, 32, k)
    shifts = torch.arange(32, device=sup.device)[:, None]
    words = (bits.long() << shifts).sum(dim=2)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def matrix_fixpoint_plain(words: torch.Tensor, scores: torch.Tensor, max_keep: int):
    """Plain twin of the fixpoint kernel: confirm/kill rounds over the
    relation ``words`` (as ``nms_relation_plain`` gives them), then each
    keeper to the slot of its rank."""
    b, k = scores.shape
    dev = scores.device
    shifts = torch.arange(32, dtype=torch.int32, device=dev)[:, None]
    sup = ((words[:, :, None, :] >> shifts) & 1).reshape(b, -1, k)[:, :k].bool()
    undecided = scores > 0.0
    kept = torch.zeros_like(undecided)
    while bool(undecided.any()):
        blocked = (sup & undecided[:, :, None]).any(dim=1)
        kept = kept | (undecided & ~blocked)
        killed = (sup & kept[:, :, None]).any(dim=1)
        undecided = undecided & blocked & ~killed
    rank = (_priority(scores) & kept[:, :, None]).sum(dim=1)  # keepers ahead of each i
    keep_idx = torch.full((b, max_keep), -1, dtype=torch.int32, device=dev)
    keep_valid = torch.zeros((b, max_keep), dtype=torch.bool, device=dev)
    rows, cols = (kept & (rank < max_keep)).nonzero(as_tuple=True)
    keep_idx[rows, rank[rows, cols]] = cols.to(torch.int32)
    keep_valid[rows, rank[rows, cols]] = True
    return keep_idx, keep_valid


def matrix_nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_threshold: float, max_keep: int):
    """Plain twin of B2: the fixpoint over the relation."""
    return matrix_fixpoint_plain(nms_relation_plain(boxes, scores, iou_threshold), scores,
                                 max_keep)


def nms_relation(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float):
    """The (B, W, K) int32 relation words for K <= 1024: the relation kernel
    on a CUDA tensor, the twin on a CPU tensor."""
    check_nms_inputs(boxes, scores, MATRIX_MAX_K, "nms_relation")
    if boxes.device.type == "cpu":
        return nms_relation_plain(boxes, scores, iou_threshold)
    check_cuda_inputs("yst_nms_relation", boxes, scores)
    b, k = scores.shape
    words = torch.empty((b, -(-k // 32), k), dtype=torch.int32, device=boxes.device)
    if b:
        _build.launch("yst_nms_relation", boxes.device, boxes.data_ptr(), scores.data_ptr(),
                      b, k, float(iou_threshold), words.data_ptr())
        nms_relation.launches += 1
    return words


nms_relation.launches = 0


def matrix_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               max_keep: int = 300):
    """Exact greedy NMS for K <= 1024: the relation and fixpoint kernels on
    a CUDA tensor, the twin on a CPU tensor."""
    check_nms_inputs(boxes, scores, MATRIX_MAX_K, "matrix_nms")
    if boxes.device.type == "cpu":
        return matrix_nms_plain(boxes, scores, iou_threshold, max_keep)
    b, k = scores.shape
    words = torch.empty((b, -(-k // 32), k), dtype=torch.int32, device=boxes.device)
    return launch_nms("yst_nms_matrix", matrix_nms, boxes, scores, iou_threshold, max_keep,
                      scratch=words)


matrix_nms.launches = 0


def _sorted_candidates(boxes: torch.Tensor, scores: torch.Tensor, chunk: int):
    """Pad K to a multiple of ``chunk`` with dead slots and sort by score
    (stable: ties keep the lower index). Returns (sorted boxes, sorted
    scores, the sort order)."""
    pad = (-scores.shape[1]) % chunk
    boxes = torch.nn.functional.pad(boxes.float(), (0, 0, 0, pad))
    scores = torch.nn.functional.pad(scores.float(), (0, pad))  # 0 = dead
    order = priority_order(scores)
    return (torch.take_along_dim(boxes, order[..., None], dim=1),
            torch.take_along_dim(scores, order, dim=1), order)


def _original_indices(order: torch.Tensor, keep_idx: torch.Tensor, keep_valid: torch.Tensor):
    """Keeper indices into the sorted axis -> into the caller's axis."""
    orig = torch.take_along_dim(order, keep_idx.clamp_min(0).long(), dim=1)
    return torch.where(keep_valid, orig.to(torch.int32), -1), keep_valid


def matrix_nms_chunked_plain(boxes: torch.Tensor, scores: torch.Tensor,
                             iou_threshold: float, max_keep: int = 300,
                             chunk: int = MATRIX_MAX_K):
    """Plain twin of B3: stable sort by score, then ``chunk``-wide strips in
    priority order through ``matrix_nms_plain``, each strip first losing the
    candidates that overlap a keeper carried from earlier strips. The carry
    is cut at ``max_keep``: a later candidate's rank would pass it. So an
    image is done once its carry is full, or once a strip starts with a
    dead candidate (the rest are dead too); a done image's strips do no
    work, as in the kernel, and the loop stops when every image is done.
    Returns indices into the original (unsorted) axis."""
    b, k = scores.shape
    if k <= chunk:
        return matrix_nms_plain(boxes, scores, iou_threshold, max_keep)
    sb, ss, order = _sorted_candidates(boxes, scores, chunk)
    dev = scores.device
    carry_box = torch.zeros((b, max_keep, 4), dtype=torch.float32, device=dev)
    carry_idx = torch.full((b, max_keep), -1, dtype=torch.int32, device=dev)
    carry_valid = torch.zeros((b, max_keep), dtype=torch.bool, device=dev)
    full = torch.zeros(b, dtype=torch.bool, device=dev)
    for c in range(ss.shape[1] // chunk):
        done = full | (ss[:, c * chunk] <= 0.0)
        if max_keep == 0 or bool(done.all()):
            break
        cb = sb[:, c * chunk:(c + 1) * chunk].contiguous()
        cs = torch.where(done[:, None], 0.0, ss[:, c * chunk:(c + 1) * chunk])
        if c > 0:
            killed = ((pairwise_iou(carry_box, cb) >= iou_threshold)
                      & carry_valid[..., None]).any(dim=1)
            cs = torch.where(killed, 0.0, cs)
        kidx, kval = matrix_nms_plain(cb, cs.contiguous(), iou_threshold, max_keep)
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
        full = carry_valid.all(dim=1)
    return _original_indices(order, carry_idx, carry_valid)


def matrix_nms_chunked(boxes: torch.Tensor, scores: torch.Tensor,
                       iou_threshold: float, max_keep: int = 300,
                       chunk: int = MATRIX_MAX_K):
    """Exact greedy NMS at any K: ``matrix_nms`` for K <= ``chunk``, else
    the strip driver, on the card for a CUDA tensor (one C call after the
    sort) and ``matrix_nms_chunked_plain`` for a CPU tensor."""
    check_nms_inputs(boxes, scores, float("inf"), "matrix_nms_chunked")
    b, k = scores.shape
    if k <= chunk:
        return matrix_nms(boxes, scores, iou_threshold, max_keep)
    if boxes.device.type == "cpu":
        return matrix_nms_chunked_plain(boxes, scores, iou_threshold, max_keep, chunk)
    check_cuda_inputs("yst_nms_matrix_chunked", boxes, scores)
    if not 1 <= chunk <= MATRIX_MAX_K:
        raise ValueError(f"matrix_nms_chunked: chunk={chunk} outside 1..{MATRIX_MAX_K}")
    dev = boxes.device
    sb, ss, order = _sorted_candidates(boxes, scores, chunk)
    keep_idx = torch.empty((b, max_keep), dtype=torch.int32, device=dev)
    keep_valid = torch.empty((b, max_keep), dtype=torch.bool, device=dev)
    if b == 0 or max_keep == 0:
        return keep_idx, keep_valid
    # one scratch for the C entry: strip words, carried boxes, carry count
    words = -(-chunk // 32) + -(-max_keep // 32)
    work = torch.empty(b * (words * chunk + max_keep * 4 + 1), dtype=torch.int32, device=dev)
    _build.launch("yst_nms_matrix_chunked", dev, sb.data_ptr(), ss.data_ptr(), b,
                  ss.shape[1], chunk, float(iou_threshold), max_keep, keep_idx.data_ptr(),
                  keep_valid.data_ptr(), work.data_ptr())
    matrix_nms_chunked.launches += 1
    return _original_indices(order, keep_idx, keep_valid)


matrix_nms_chunked.launches = 0
