"""The NMS bound and the IoU count it rests on, and the render bound, on
fixed inputs."""

import numpy as np
import pytest
import torch

from port_bench.core.roofline import (FP32_FLOP_PER_S, HBM_BYTES_PER_S, IOU_OPS, nms_bound_ms,
                                      render_bound_ms)
from port_bench.reference import detect


def test_bound_by_bytes():
    n_bytes = 256 * 512 * 20 + 256 * 300 * 5
    assert nms_bound_ms(256, 512, 300, 0) == pytest.approx(n_bytes / HBM_BYTES_PER_S * 1e3)


def test_bound_by_operations():
    ious = 10**9
    assert nms_bound_ms(1, 512, 300, ious) == pytest.approx(ious * IOU_OPS / FP32_FLOP_PER_S * 1e3)


def test_greedy_ious():
    # four live candidates, sorted: 0 and 1 overlap fully, 2 and 3 are apart
    boxes = torch.tensor([[[0, 0, 10, 10], [0, 0, 10, 10], [20, 20, 30, 30],
                           [40, 40, 50, 50], [0, 0, 1, 1]]], dtype=torch.float32)
    scores = torch.tensor([[0.9, 0.8, 0.7, 0.6, 0.0]])
    keep, valid = detect.greedy_nms(boxes, scores, 0.45, 4)
    assert keep[0, :3].tolist() == [0, 2, 3] and valid[0].tolist() == [True, True, True, False]
    # 3 keepers: 3 IoUs among them, and one for the killed candidate
    n = valid.sum(1)
    seen = torch.where(valid.all(1), keep[:, -1] + 1, (scores > 0).sum(1))
    assert int(n * (n - 1) // 2 + seen - n) == 4


def test_render_bound_by_bytes():
    # two samples: one 100 x 50 tile each, and a rect that no tile covers
    rects = np.zeros((2, 8, 4), np.float32)
    rects[:, 0] = (10, 20, 110, 70)
    rects[1, 1] = (5, 5, 3, 3)
    plan = {"rects": rects, "mix": np.ones(2, np.float32)}
    batch = {"plan": plan, "ann": np.zeros((2, 300, 6), np.float32), "dst_hw": (64, 32)}
    moved = 2 * 100 * 50 * 3 + rects.nbytes + 8 + 2 * 64 * 32 * 3
    assert render_bound_ms(batch) == pytest.approx(moved / HBM_BYTES_PER_S * 1e3)
