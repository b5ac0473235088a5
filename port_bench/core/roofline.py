"""The card's published peaks and the least time of a kernel's work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): 67 TFLOP/s in f32 outside the tensor cores, which is
the precision the configurations state (f32, TF32 off), and 3.35 TB/s of
device memory.
"""

from __future__ import annotations

import numpy as np

from .flops import epilogue_elements

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
IOU_OPS = 14  # min/max/sub/clamp/mul/add/div/compare per IoU evaluation


def nms_bound_ms(batch: int, k: int, max_keep: int, ious: int) -> float:
    """Least time of one greedy NMS call on the card: the larger of bytes
    over the memory rate (boxes and scores read once, keep_idx and
    keep_valid written once) and ``ious`` IoU evaluations over the f32
    rate (``ious``: what exact greedy cannot avoid on the call's inputs,
    ``reference/detect.py``)."""
    n_bytes = batch * k * (16 + 4) + batch * max_keep * (4 + 1)
    return max(n_bytes / HBM_BYTES_PER_S, ious * IOU_OPS / FP32_FLOP_PER_S) * 1e3


def bn_silu_bound_ms(cfg: dict, batch: int, size: int) -> float:
    """Least time of one forward's eval BN + SiLU epilogues on the card, by
    bytes: every element of each conv + BN + SiLU block's output read once
    and written once in f32 (8 bytes), over the memory rate; the
    per-channel scales and shifts are left out (under 0.01%)."""
    return 8 * sum(epilogue_elements(cfg, batch, size)) / HBM_BYTES_PER_S * 1e3


def render_bound_ms(batch) -> float:
    """Least time of one render of a loader's plan batch on the card, by
    bytes: every tile pixel that a rect covers read once (both mixup
    layers), the plan's fields read once, the uint8 output written once,
    over the memory rate."""
    rects = batch["plan"]["rects"]
    covered = np.clip(rects[..., 2] - rects[..., 0], 0, None) * np.clip(
        rects[..., 3] - rects[..., 1], 0, None)
    h, w = batch["dst_hw"]
    moved = (float(covered.sum()) * 3 + sum(v.nbytes for v in batch["plan"].values())
             + len(batch["ann"]) * h * w * 3)
    return moved / HBM_BYTES_PER_S * 1e3
