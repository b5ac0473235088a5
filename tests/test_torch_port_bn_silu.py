"""The eval-mode BN + SiLU epilogue of ``ConvBnAct`` on the CPU: which blocks
take the kernel (``nn/layers.py::takes_bn_silu_kernel``), the plain twin
against the eval ops it replaces, bit for bit, and the wrapper's argument
checks (``kernels/bn_silu.py``). The kernel itself runs on the card only
(``tests/test_torch_port_gpu_bn_silu.py``)."""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from yoloseries_tpu_torch.kernels import bn_silu as kernel
from yoloseries_tpu_torch.models import create_model
from yoloseries_tpu_torch.nn import layers


def _bn(c, seed=0, training=False):
    """A ``BatchNorm`` with running statistics and an affine drawn from
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    bn = layers.BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=gen) * 2 + 0.1)
        bn.bias.copy_(torch.randn(c, generator=gen))
        bn.running_mean.copy_(torch.randn(c, generator=gen))
        bn.running_var.copy_(torch.rand(c, generator=gen) * 3)
    return bn.train(training)


def _on_card(dtype=torch.float32, contiguous=True):
    """Stands in for a conv output on a CUDA device: the predicate reads
    only its device, dtype and layout."""
    return SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                           is_contiguous=lambda: contiguous)


@pytest.mark.parametrize("case,bn,y,grad,want", [
    ("eval, no grad, CUDA f32", _bn(4), _on_card(), False, True),
    ("eval, no grad, CUDA bf16", _bn(4), _on_card(torch.bfloat16), False, True),
    ("training-mode BN", _bn(4, training=True), _on_card(), False, False),
    ("eval with grad on", _bn(4), _on_card(), True, False),
    ("f64 yardstick", _bn(4), _on_card(torch.float64), False, False),
    ("f16", _bn(4), _on_card(torch.float16), False, False),
    ("CPU tensor", _bn(4), torch.zeros(1, 4, 2, 2), False, False),
    ("folded block", nn.Identity(), _on_card(), False, False),
    ("not contiguous", _bn(4), _on_card(contiguous=False), False, False),
])
def test_route_to_kernel(case, bn, y, grad, want):
    with torch.set_grad_enabled(grad):
        assert layers.takes_bn_silu_kernel(bn, y) is want, case


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [True, False])
def test_plain_twin_is_the_eval_ops(dtype, act):
    """``bn_silu_plain`` against ``BatchNorm._affine`` then ``F.silu`` and
    the block's cast, bit for bit."""
    bn = _bn(6, seed=3)
    y = (torch.randn(2, 6, 5, 7, generator=torch.Generator().manual_seed(4)) * 4).to(dtype)
    with torch.no_grad():
        x = bn._affine(y, bn.running_mean, bn.running_var)
        want = (F.silu(x) if act else x).to(dtype)
        got = kernel.bn_silu_plain(y, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                   bn.eps, act)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def _args(c=4, shape=(2, 4, 3, 5), dtype=torch.float32):
    y = torch.randn(shape).to(dtype)
    vecs = [torch.rand(c) + 0.5 for _ in range(4)]
    return y, vecs


@pytest.mark.parametrize("case", [
    "f16", "f64", "not contiguous", "3-D", "weight length", "var length", "f64 mean",
    "out dtype", "out shape",
])
def test_wrapper_refuses(case):
    y, vecs = _args()
    out = None
    err = ValueError
    if case in ("f16", "f64"):
        y, err = y.to(torch.float16 if case == "f16" else torch.float64), TypeError
    elif case == "not contiguous":
        y = y.transpose(2, 3)
    elif case == "3-D":
        y = y[0]
    elif case == "weight length":
        vecs[0] = torch.rand(5)
    elif case == "var length":
        vecs[3] = torch.rand(3)
    elif case == "f64 mean":
        vecs[2], err = vecs[2].double(), TypeError
    elif case == "out dtype":
        out = torch.empty_like(y, dtype=torch.bfloat16)
    elif case == "out shape":
        out = torch.empty(2, 4, 3, 4)
    with pytest.raises(err):
        kernel.check_bn_silu_inputs(y, *vecs, out)
    with pytest.raises(err):
        kernel.bn_silu(y, *vecs, 1e-3, out=out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_runs_the_twin_in_place(dtype):
    y, vecs = _args(dtype=dtype)
    want = kernel.bn_silu_plain(y, *vecs, 1e-3)
    assert torch.equal(kernel.bn_silu(y, *vecs, 1e-3), want)
    out = kernel.bn_silu(y, *vecs, 1e-3, out=y)
    assert out is y and torch.equal(y, want)


@pytest.mark.parametrize("name,blocks", [("yolov5s", 57), ("yolox_s", 66)])
def test_every_block_of_a_forward_takes_the_route(monkeypatch, name, blocks):
    """With the route taken on the CPU (the wrapper then runs the twin, over
    the conv's output), a forward calls the wrapper once a ``ConvBnAct``
    and gives the plain forward's maps, bit for bit."""
    model = create_model(name, num_class=80, device="cpu", seed=1)
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        want = model(x)
    calls = []

    def counted(*args, **kwargs):
        calls.append(kwargs["out"] is args[0])
        return kernel.bn_silu(*args, **kwargs)

    monkeypatch.setattr(layers, "bn_silu", counted)
    monkeypatch.setattr(layers, "takes_bn_silu_kernel",
                        lambda bn, y: isinstance(bn, layers.BatchNorm) and not bn.training
                        and not torch.is_grad_enabled())
    with torch.inference_mode():
        got = model(x)
    assert sum(isinstance(m, layers.ConvBnAct) for m in model.modules()) == blocks
    assert len(calls) == blocks and all(calls)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    calls.clear()
    with torch.no_grad():
        model.train()(x)  # training-mode BN: the plain path
    assert not calls
