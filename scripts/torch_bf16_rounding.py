"""Two bf16 roundings of the port's YOLOv5s serving path, side by side.

The port's bf16 model (``yoloseries_tpu_torch/nn/layers.py``) computes BN's
affine and SiLU in f32 and rounds once after the activation, as an XLA fusion
does when it may keep excess precision. JAX's bf16 modules, run op by op,
round after every op: BN's multiply and add by factors rounded to bf16, SiLU
as ``x * 1 / (1 + exp(-x))`` (XLA's expansion of ``lax.logistic``), the
detect convs' bias added after the rounded convolution. This script patches
the second arithmetic into the port's classes for one pass and measures both
against the f32 model on the same seeded weights and images (``chip_smoke.py``
phase 11's bf16 serving check: share of f32 detections matched at conf 0.02
and 4 px, and img/s, in turns).

    python3 scripts/torch_bf16_rounding.py                    # H100: B=256 at 640
    python3 scripts/torch_bf16_rounding.py --device cpu --size 320 --batch 8
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from yoloseries_tpu_torch.nn import layers  # noqa: E402


def _affine_op_by_op(self, x, mean, var):
    mul = self.weight * torch.rsqrt(var + self.eps)
    shift = self.bias - mean * mul
    mul, shift = mul.to(x.dtype), shift.to(x.dtype)
    return x * mul[None, :, None, None] + shift[None, :, None, None]


def _conv_bn_act_op_by_op(self, x):
    x = self.bn(self.conv(x))
    if not self.act:
        return x
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.reciprocal(torch.exp(-x) + 1)


def _conv_op_by_op(self, x):
    if x.dtype == torch.float32 or self.bias is None:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)
    y = self._conv_forward(x, self.weight.to(x.dtype), None)
    return y + self.bias.to(x.dtype)[None, :, None, None]


@contextlib.contextmanager
def op_by_op():
    """The port's bf16 layers with JAX's op-by-op rounding, for the block."""
    saved = (layers.BatchNorm._affine, layers.ConvBnAct.forward, layers.Conv2d.forward)
    layers.BatchNorm._affine = _affine_op_by_op
    layers.ConvBnAct.forward = _conv_bn_act_op_by_op
    layers.Conv2d.forward = _conv_op_by_op
    try:
        yield
    finally:
        layers.BatchNorm._affine, layers.ConvBnAct.forward, layers.Conv2d.forward = saved


def main(argv=None):
    from yoloseries_tpu_torch.models import create_model

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.benchmark = True

    gen = torch.Generator().manual_seed(0)
    calib = (torch.randint(0, 256, (2, 3, args.size // 2, args.size // 2), generator=gen)
             .float() / 255).to(dev)
    model = create_model("yolov5s", num_class=80, device="cpu", seed=0).to(dev)
    smoke.widen_head(model, calib)
    bf = create_model("yolov5s", num_class=80, device="cpu", dtype=torch.bfloat16)
    bf.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    bf = bf.to(dev).eval()
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (args.batch, args.size, args.size, 3), dtype=np.uint8)
    cfg = smoke.EvalConfig(**smoke.SERVING)
    evs = {"f32": smoke.evaluator(model.eval(), cfg, device=dev),
           "bf16": smoke.evaluator(bf, cfg, device=dev)}
    evs["bf16 op by op"] = evs["bf16"]

    best, dets = {}, {}
    for which in ("f32", "bf16", "bf16 op by op", "bf16 op by op", "bf16", "f32"):
        with op_by_op() if which == "bf16 op by op" else contextlib.nullcontext():
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = evs[which](img)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        best[which] = min(ms, best.get(which, float("inf")))
        dets[which] = out
    result = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
              "size": args.size, "batch": args.batch}
    for which in ("f32", "bf16", "bf16 op by op"):
        result[which] = {"img_per_s": args.batch / best[which] * 1e3}
        if which != "f32":
            share, total = smoke.matched_share(dets[which], dets["f32"], smoke.BF16_CONF_TOL,
                                               smoke.BF16_BOX_TOL)
            result[which].update(matched=share, f32_detections=total)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
