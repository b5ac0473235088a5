"""Plain PyTorch building blocks of the detectors' forwards over a flat
state dict, and the entry points that run a configuration's family
(``families/<family>.py``) on them.

Written from the published architectures (the shared trunk: ultralytics/
yolov5 ``models/yolov5s.yaml``'s 6x6/2 stem, CSPDarknet with C3 blocks,
SPPF and PANet; each family's head in its module), in f32 with
``F.conv2d`` and nothing else of a library: BatchNorm with eps 1e-3 in
eval form (``x * mul + shift``), SiLU, nearest 2x upsampling, 5x5 stride-1
max pools. Block counts and widths come from the configuration's
``depth_multiple`` / ``width_multiple``.

Parameter names follow the state dict keys the port's modules carry, so one
state dict made here loads into the port with ``load_state_dict(strict=True)``
(a check that the two architectures have the same parameters).

``Net`` runs in four modes: ``build`` (a parameter missing from the dict
is created with the shape its call implies, so one forward enumerates the
parameters), ``calibrate`` (every BN normalises with its batch statistics
and stores them as its running statistics), ``train`` (every BN normalises
with its batch statistics, two-pass, in the centred form
``(x - mean) / sqrt(var + eps) x gamma + beta``, and moves its running statistics
towards them by ``BN_MOMENTUM``, the variance unbiased, as PyTorch's
``BatchNorm2d`` defines it) and plain eval. In every mode it lists the
element count of each conv + BN + SiLU block's output (``epilogues``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .families import family

BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # the recipe's: flax's 0.97


def _depth(n: int, multiple: float) -> int:
    return max(round(n * multiple), 1)


class Net:
    def __init__(self, sd: dict, mode: str = "eval"):
        if mode not in ("build", "calibrate", "train", "eval"):
            raise ValueError(f"mode {mode!r}")
        self.sd, self.mode = sd, mode
        self.convs = []  # (weight key, bias key or None) in forward order, build mode
        self.epilogues = []  # elements of each cba's BN output, in forward order

    def _param(self, key, shape, like, fill):
        if key not in self.sd:
            if self.mode != "build":
                raise KeyError(key)
            self.sd[key] = torch.full(shape, float(fill), device=like.device, dtype=like.dtype)
        return self.sd[key]

    def conv(self, p, x, cout, k, s=1, pad=None, bias=False):
        w = self._param(f"{p}.weight", (cout, x.shape[1], k, k), x, 0.0)
        b = self._param(f"{p}.bias", (cout,), x, 0.0) if bias else None
        if self.mode == "build":
            self.convs.append((f"{p}.weight", f"{p}.bias" if bias else None))
        return F.conv2d(x, w, b, s, k // 2 if pad is None else pad)

    def bn(self, p, y):
        c = y.shape[1]
        gamma = self._param(f"{p}.weight", (c,), y, 1.0)
        beta = self._param(f"{p}.bias", (c,), y, 0.0)
        mean = run_mean = self._param(f"{p}.running_mean", (c,), y, 0.0)
        var = run_var = self._param(f"{p}.running_var", (c,), y, 1.0)
        if self.mode == "build":
            self.sd.setdefault(f"{p}.num_batches_tracked",
                               torch.zeros((), dtype=torch.long, device=y.device))
        if self.mode == "train":  # (y - mean) / sqrt(var + eps) x gamma + beta
            mean = y.mean(dim=(0, 2, 3))
            yc = y - mean[None, :, None, None]
            var = yc.square().mean(dim=(0, 2, 3))
            n = y.numel() // c
            with torch.no_grad():
                run_mean.lerp_(mean, BN_MOMENTUM)
                run_var.lerp_(var * (n / max(n - 1, 1)), BN_MOMENTUM)
            mul = gamma * torch.rsqrt(var + BN_EPS)
            return yc * mul[None, :, None, None] + beta[None, :, None, None]
        if self.mode == "calibrate":
            mean.copy_(y.mean(dim=(0, 2, 3)))
            var.copy_(y.var(dim=(0, 2, 3), unbiased=False))
        mul = gamma * torch.rsqrt(var + BN_EPS)
        shift = beta - mean * mul
        return y * mul[None, :, None, None] + shift[None, :, None, None]

    def cba(self, p, x, cout, k, s=1, pad=None):
        """Conv (no bias) + BN + SiLU."""
        y = self.bn(f"{p}.bn", self.conv(f"{p}.conv", x, cout, k, s, pad))
        self.epilogues.append(y.numel())
        return F.silu(y)


def _c3(net, p, x, cout, n, shortcut):
    mid = cout // 2
    y = net.cba(f"{p}.cba1", x, mid, 1)
    for i in range(n):
        z = net.cba(f"{p}.blocks.{i}.conv_bn_act_1", y, mid, 1)
        z = net.cba(f"{p}.blocks.{i}.conv_bn_act_2", z, mid, 3)
        y = z + y if shortcut else z
    return net.cba(f"{p}.cba3", torch.cat([y, net.cba(f"{p}.cba2", x, mid, 1)], 1), cout, 1)


def _sppf(net, p, x, cout):
    x = net.cba(f"{p}.cba1", x, x.shape[1] // 2, 1)
    x2 = F.max_pool2d(x, 5, 1, 2)
    x3 = F.max_pool2d(x2, 5, 1, 2)
    x4 = F.max_pool2d(x3, 5, 1, 2)
    return net.cba(f"{p}.cba2", torch.cat([x, x2, x3, x4], 1), cout, 1)


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def csp_trunk(net, x, cfg, pre=""):
    """Backbone and PAN of ``models/yolov5s.yaml``; the three PAN maps."""
    w = round(64 * cfg["width_multiple"])  # stem width: 64 scaled
    dm = cfg["depth_multiple"]
    n1, n2, n3, n4 = (_depth(n, dm) for n in (3, 6, 9, 3))
    nh = _depth(3, dm)
    x = net.cba(f"{pre}focus", x, w, 6, 2, 2)
    x = _c3(net, f"{pre}backbone_stage1_bscp",
            net.cba(f"{pre}backbone_stage1_conv", x, 2 * w, 3, 2), 2 * w, n1, True)
    p3 = _c3(net, f"{pre}backbone_stage2_bscp",
             net.cba(f"{pre}backbone_stage2_conv", x, 4 * w, 3, 2), 4 * w, n2, True)
    p4 = _c3(net, f"{pre}backbone_stage3_bscp",
             net.cba(f"{pre}backbone_stage3_conv", p3, 8 * w, 3, 2), 8 * w, n3, True)
    x = net.cba(f"{pre}backbone_stage4_conv", p4, 16 * w, 3, 2)
    p5 = _sppf(net, f"{pre}backbone_stage4_spp",
               _c3(net, f"{pre}backbone_stage4_bscp", x, 16 * w, n4, True), 16 * w)
    h1 = net.cba(f"{pre}head_stage1_conv", p5, 8 * w, 1)
    x = _c3(net, f"{pre}head_stage1_bscp", torch.cat([_up(h1), p4], 1), 8 * w, nh, False)
    h2 = net.cba(f"{pre}head_stage2_conv", x, 4 * w, 1)
    small = _c3(net, f"{pre}head_stage2_bscp", torch.cat([_up(h2), p3], 1), 4 * w, nh, False)
    x = net.cba(f"{pre}head_stage3_conv", small, 4 * w, 3, 2)
    mid = _c3(net, f"{pre}head_stage3_bscp", torch.cat([x, h2], 1), 8 * w, nh, False)
    x = net.cba(f"{pre}head_stage4_conv", mid, 8 * w, 3, 2)
    large = _c3(net, f"{pre}head_stage4_bscp", torch.cat([x, h1], 1), 16 * w, nh, False)
    return [small, mid, large]


def forward(sd, x, cfg, mode="eval"):
    return family(cfg).forward(Net(sd, mode), x, cfg)


def output_convs(cfg):
    """The family's output convs (``families/__init__.py``)."""
    return family(cfg).output_convs(cfg)


def build_state(cfg, device, size=64):
    """Every parameter and buffer at its shape (conv weights 0, BN at the
    identity), and the conv (weight, bias) keys in forward order."""
    sd = {}
    net = Net(sd, "build")
    with torch.no_grad():
        family(cfg).forward(net, torch.zeros(1, 3, size, size, device=device), cfg)
    return sd, net.convs
