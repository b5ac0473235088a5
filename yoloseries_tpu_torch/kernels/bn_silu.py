"""The eval-mode BN affine and SiLU of ``ConvBnAct`` in one pass: the CUDA
kernel ``csrc/bn_silu.cu`` and its plain PyTorch twin.

Replaces no Pallas kernel (XLA fuses the same epilogue on the TPU).
Contract: ``y`` (N, C, H, W) contiguous, f32 or bf16; ``weight``, ``bias``,
``mean``, ``var`` (C,) f32; returns ``silu(y * mul + shift)`` (or the affine
alone with ``act=False``) in ``y``'s dtype, with ``mul = weight * rsqrt(var +
eps)`` and ``shift = bias - mean * mul``, computed in f32 and rounded once.

``bn_silu_plain`` is ``BatchNorm._affine`` then ``F.silu`` and the block's
cast (``nn/layers.py::ConvBnAct``), op for op; the kernel is bit-identical
to it on the card. ``bn_silu`` runs the twin for a tensor on the CPU and the
kernel for a tensor on a CUDA device; the counter ``bn_silu.launches``
(``utils/trace.py``) counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import trace
from . import _build

__all__ = ["DTYPE_CODES", "bn_silu", "bn_silu_plain", "check_bn_silu_inputs"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the C entry's dtype argument


def bn_silu_plain(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  mean: torch.Tensor, var: torch.Tensor, eps: float,
                  act: bool = True) -> torch.Tensor:
    """The epilogue in plain PyTorch: the eval path of ``ConvBnAct``."""
    mul = weight * torch.rsqrt(var + eps)
    shift = bias - mean * mul
    x = y * mul[None, :, None, None] + shift[None, :, None, None]
    return (F.silu(x) if act else x).to(y.dtype)


def check_bn_silu_inputs(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         mean: torch.Tensor, var: torch.Tensor,
                         out: torch.Tensor | None = None) -> None:
    """Raise on inputs the kernel does not take."""
    if y.dim() != 4:
        raise ValueError(f"bn_silu: want y (N, C, H, W), got {tuple(y.shape)}")
    if y.dtype not in DTYPE_CODES:
        raise TypeError(f"bn_silu: y must be float32 or bfloat16, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("bn_silu: y must be contiguous (NCHW)")
    for name, t in (("weight", weight), ("bias", bias), ("mean", mean), ("var", var)):
        if t.shape != (y.shape[1],):
            raise ValueError(f"bn_silu: want {name} ({y.shape[1]},), got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"bn_silu: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous() or t.device != y.device:
            raise ValueError(f"bn_silu: {name} must be contiguous on y's device")
    if out is not None and (out.shape != y.shape or out.dtype != y.dtype
                            or not out.is_contiguous() or out.device != y.device):
        raise ValueError("bn_silu: out must be a contiguous tensor like y")


def bn_silu(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float, act: bool = True,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """The epilogue into ``out`` (a new tensor when None; ``y`` itself is
    allowed): the CUDA kernel on a CUDA tensor, ``bn_silu_plain`` on a CPU
    tensor."""
    check_bn_silu_inputs(y, weight, bias, mean, var, out)
    if y.device.type == "cpu":
        res = bn_silu_plain(y, weight, bias, mean, var, eps, act)
        return res if out is None else out.copy_(res)
    if y.device.type != "cuda":
        raise ValueError("bn_silu: tensors must be on the CPU or a CUDA device")
    if out is None:
        out = torch.empty_like(y)
    n, c, h, w = y.shape
    if y.numel() == 0:
        return out
    _build.launch("yst_bn_silu", y.device, y.data_ptr(), out.data_ptr(), n, c, h * w,
                  weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), var.data_ptr(),
                  float(eps), int(act), DTYPE_CODES[y.dtype])
    trace.count("bn_silu.launches")
    return out
