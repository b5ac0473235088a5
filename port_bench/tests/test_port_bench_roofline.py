"""The NMS bound and the IoU count it rests on, the render bound, and the
BN + SiLU bound and its reader, on fixed inputs."""

import numpy as np
import pytest
import torch

from port_bench.core import spec
from port_bench.core.flops import epilogue_elements
from port_bench.core.roofline import (FP32_FLOP_PER_S, HBM_BYTES_PER_S, IOU_OPS,
                                      bn_silu_bound_ms, nms_bound_ms, render_bound_ms)
from port_bench.core.trace import Summary
from port_bench.reference import detect

BENCH = spec.load_bench()


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


@pytest.mark.parametrize("name,epilogues", [("yolov5s", 57), ("yolox_s", 66)])
def test_bn_silu_epilogues(name, epilogues):
    # one a ``ConvBnAct`` of the port's model, as K1's ``bn_silu.launches`` counts them
    from yoloseries_tpu_torch.models import create_model
    from yoloseries_tpu_torch.nn.layers import ConvBnAct

    cfg = spec.config(BENCH, name)
    assert len(epilogue_elements(cfg, 2, 64)) == epilogues
    model = create_model(cfg["program_model"], num_class=cfg["nc"], device="meta", seed=0)
    assert sum(isinstance(m, ConvBnAct) for m in model.modules()) == epilogues


@pytest.mark.parametrize("name,batch,ms", [("yolov5s", 256, 14.4610), ("yolox_s", 16, 1.0271)])
def test_bn_silu_bound(name, batch, ms):
    cfg = spec.config(BENCH, name)
    elements = sum(epilogue_elements(cfg, batch, 640))
    assert bn_silu_bound_ms(cfg, batch, 640) == pytest.approx(
        elements * 8 / HBM_BYTES_PER_S * 1e3)
    assert bn_silu_bound_ms(cfg, batch, 640) == pytest.approx(ms, rel=0.01)


def test_bn_silu_reader():
    read = spec.reader("bn_silu_roofline.serve")
    assert spec.reader("bn_silu_roofline.tail") is not None
    dev = [("void bn_silu_kernel<float, true>(Args)", 0.0, 300.0),
           ("void bn_silu_kernel<float, false>(Args)", 300.0, 500.0),
           ("cutlass_conv", 500.0, 900.0)]
    s = Summary(window_us=1000.0, busy_us=900.0, launches=3, kernels=3, device=dev)
    cfg = spec.config(BENCH, "yolox_s")
    ctx = {"summary": s, "traced": [0, 1], "cfg": cfg,
           "traffic": {"batch": 2, "image_size": 64}}
    bound_us = 2 * bn_silu_bound_ms(cfg, 2, 64) * 1e3  # two calls over 500 us
    assert read(ctx) == pytest.approx(100.0 * bound_us / 500.0)
    assert read(dict(ctx, traced=[])) is None
    none_ran = Summary(window_us=1000.0, busy_us=400.0, launches=1, kernels=1,
                       device=dev[2:])
    assert read(dict(ctx, summary=none_ran)) is None
    assert read(dict(ctx, summary=None)) is None
