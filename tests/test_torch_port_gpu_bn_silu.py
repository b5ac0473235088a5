"""The eval-mode BN + SiLU kernel (``csrc/bn_silu.cu``) on the card: bit for
bit against its plain twin at the serving cells' shapes, at planes that
split a vector and from a misaligned pointer, in place and not; whole
``Evaluator`` calls with and without it; no launch in training.

Marked ``gpu``; each test takes the ``cuda`` fixture, which skips when no
card is visible (decided at run time, never at import). On a machine with a
card and the CUDA toolkit:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu_bn_silu.py

This file imports no JAX: the card machine need not have it.
"""

import math

import numpy as np
import pytest
import torch

from yoloseries_tpu_torch.kernels import bn_silu as kernel
from yoloseries_tpu_torch.nn import layers
from yoloseries_tpu_torch.utils import trace

pytestmark = pytest.mark.gpu

EXTREMES = [-200.0, -88.0, -20.0, 0.0, -0.0, 1e-30, 20.0, 88.0, 200.0]


def launches():
    return trace.totals()["counters"].get("bn_silu.launches", 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(shape, dtype, dev, seed, offset=0):
    """y of ``shape`` (scaled so SiLU sees both tails, the extremes first)
    starting ``offset`` elements into its buffer, and the four f32
    vectors."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(math.prod(shape) + offset, generator=gen, device=dev) * 4
    flat[offset:offset + len(EXTREMES)] = torch.tensor(EXTREMES, device=dev)
    y = flat.to(dtype)[offset:].view(shape)
    c = shape[1]
    vecs = (torch.rand(c, generator=gen, device=dev) * 2 + 0.1,
            torch.randn(c, generator=gen, device=dev),
            torch.randn(c, generator=gen, device=dev),
            torch.rand(c, generator=gen, device=dev) * 3)
    return y, vecs


@pytest.mark.parametrize("shape,offset", [
    ((256, 32, 320, 320), 0),  # the B=256 stem's output
    ((16, 512, 20, 20), 0),  # B=16's smallest planes, packed
    ((16, 64, 160, 160), 0),  # planes of several chunks, the last one partial
    ((2, 8, 13, 13), 0),  # H*W a multiple of no vector width
    ((3, 5, 1, 1), 0),  # one element a plane
    ((2, 3, 161, 161), 0),  # odd planes in chunks
    ((4, 16, 40, 40), 1),  # a misaligned pointer: a scalar head and tail
    ((2, 8, 13, 13), 3),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [True, False])
def test_kernel_matches_twin(cuda, shape, offset, dtype, act):
    y, vecs = _inputs(shape, dtype, cuda, sum(shape) + offset, offset)
    assert y.is_contiguous() and (y.data_ptr() % 16 != 0) == bool(offset)
    want = kernel.bn_silu_plain(y, *vecs, 1e-3, act)
    trace.reset()
    got = kernel.bn_silu(y, *vecs, 1e-3, act)
    torch.cuda.synchronize()
    assert launches() == 1
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_place_equals_out_of_place(cuda, dtype):
    y, vecs = _inputs((8, 24, 80, 80), dtype, cuda, seed=5)
    apart = kernel.bn_silu(y, *vecs, 1e-3)
    same = kernel.bn_silu(y, *vecs, 1e-3, out=y)
    torch.cuda.synchronize()
    assert same is y
    assert torch.equal(apart, y)


def _yolov5s():
    from yoloseries_tpu_torch.models import create_model

    model = create_model("yolov5s", num_class=80, device="cpu", seed=1)
    with torch.no_grad():
        for name in ("detect_small", "detect_mid", "detect_large"):
            getattr(model.detect, name).bias.zero_()
    return model


def _yolox_s():
    from yoloseries_tpu_torch.models import create_model

    model = create_model("yolox_s", num_class=80, device="cpu", seed=1)
    with torch.no_grad():  # scores and boxes spread as a trained head's
        for head in (model.detect.pred_small, model.detect.pred_middle,
                     model.detect.pred_large):
            for conv in (head.cls[-1], head.reg, head.cof):
                conv.bias.zero_()
            head.reg.bias[2:] = 2.0
    return model


@pytest.mark.parametrize("name,blocks", [("yolov5s", 57), ("yolox_s", 66)])
def test_evaluator_with_kernel_matches_plain_epilogue(cuda, monkeypatch, name, blocks):
    """A whole ``Evaluator`` call with the kernel and with the route patched
    off: identical detections, and ``blocks`` launches a call."""
    from yoloseries_tpu_torch.evaluation import EvalConfig, Evaluator
    from yoloseries_tpu_torch.families import get_family

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    family = get_family(name)
    size = (640, 640)
    # the merge would drop a random head's unsupported keepers: all of them
    cfg = EvalConfig(conf_threshold=0.001, cls_threshold=0.001, iou_threshold=0.65,
                     num_candidates=1024, merge_boxes=False)
    model = (_yolov5s() if name == "yolov5s" else _yolox_s()).to(cuda)
    ev = Evaluator(model, family.make_decode({}, 80, size), cfg,
                   family.make_select({}, 80, size)(cfg), device=cuda)
    img = np.random.default_rng(0).integers(0, 256, (4, *size, 3), dtype=np.uint8)
    ev(img)  # warm-up
    trace.reset()
    fused = ev(img)
    torch.cuda.synchronize()
    assert launches() == blocks
    monkeypatch.setattr(layers, "takes_bn_silu_kernel", lambda bn, y: False)
    plain = ev(img)
    torch.cuda.synchronize()
    assert launches() == blocks
    assert int((plain[..., 4] > 0).sum()) > 0
    assert torch.equal(fused, plain)


def test_no_launch_in_training_or_with_grad(cuda):
    """Training-mode BN and eval with grad on keep the plain ops."""
    model = _yolov5s().to(cuda)
    x = torch.rand(2, 3, 128, 128, device=cuda)
    trace.reset()
    model.train()
    sum(o.float().sum() for o in model(x)).backward()
    model.eval()
    model(x)
    torch.cuda.synchronize()
    assert launches() == 0
    with torch.no_grad():
        model(x)
    assert launches() == 57
