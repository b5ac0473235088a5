"""YOLOv7: E-ELAN backbone, CSP-SPP head, RepConv outputs and YOLOR's
implicit layers around the detect convs, NCHW.

Counterpart of ``yoloseries_tpu/models/yolov7.py``:

* backbone: 3x3 stem, two 3x3 convs to /2, a 3x3/2 conv to /4 and an ELAN4
  block, then three [MPDown -> ELAN4] stages to /8, /16, /32 (routes tapped
  at /8 and /16);
* head: CSPCSPP on /32, two top-down ELAN6 blocks (1x1 lateral + 2x
  upsample beside a 1x1 route), two bottom-up ELAN6 blocks after MPDown;
* outputs: a RepConv 3x3 per scale (256, 512, 1024 channels), then
  ``ImplicitAdd`` -> a biased 1x1 detect conv -> ``ImplicitMul``; the detect
  bias prior is YOLOv5's at a 640 reference size.

Widths are fixed (32 to 1024): the reference has one YOLOv7 size.

Knobs as in the JAX package: ``dtype`` (the compute dtype), ``remat`` (each
ELAN block recomputed in the backward through ``torch.utils.checkpoint``;
YOLOv7 at 640 holds the largest activations of the families), ``deploy``
(RepConv in its reparameterized form, weights from
``nn/deploy.py::fold_repconv``).

Names: the reference hand-unrolls every block into flat conv modules
(``backbone.backbone_stage3_conv4``, ``head.head_eelan2_conv5``,
``head.head_spp.cba3``, ``head.head_output_repconv1.rbr_dense.0``,
``detect.detect_s``, ``detect.implicitadd_s``), and so does the port, so
that ``convert_yolov7_state_dict`` of the JAX package reads a port
``state_dict``. ``elan4``, ``elan6`` and ``mp_down`` are the JAX package's
``ELAN4``, ``ELAN6`` and ``MPDown`` over those flat convs.

Input (B, 3, H, W) in [0, 1], H and W multiples of 32. Returns three raw
maps (B, A*(5+nc), H/s, W/s) at s = 8, 16, 32, as YOLOv5's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.layers import (
    CSPCSPP,
    Conv2d,
    ConvBnAct,
    ImplicitAdd,
    ImplicitMul,
    RepConv,
    kaiming_fan_out_,
    remat_context,
    upsample2x,
)

__all__ = ["YOLOv7", "elan4", "elan6", "mp_down", "v7_detect_bias"]

V7_SCALES = ("s", "m", "l")


def v7_detect_bias(stride: int, num_class: int, num_anchor: int) -> torch.Tensor:
    """(A * (5 + nc),) prior: obj log(8 / (640/s)^2), cls log(0.6 / (nc - 0.99))."""
    b = torch.zeros(num_anchor, 5 + num_class, dtype=torch.float64)
    b[:, 4] = math.log(8.0 / (640.0 / stride) ** 2)
    b[:, 5:] = math.log(0.6 / (num_class - 0.99))
    return b.float().reshape(-1)


def elan4(convs, x):
    """Backbone ELAN: two 1x1 entries, two 3x3 pairs with a tap after each,
    the four taps (last first) through a 1x1. ``convs`` = (cv1, cv2, cv3,
    cv4, cv5, cv6, cv_out)."""
    cv1, cv2, cv3, cv4, cv5, cv6, out = convs
    t1, t2 = cv1(x), cv2(x)
    t3 = cv4(cv3(t2))
    t4 = cv6(cv5(t3))
    return out(torch.cat([t4, t3, t2, t1], dim=1))


def elan6(convs, x):
    """Head ELAN: two 1x1 entries, four chained 3x3 convs at half width with
    a tap after every conv, the six taps (last first) through a 1x1."""
    cv1, cv2, *chain, out = convs
    taps = [cv1(x), cv2(x)]
    for conv in chain:
        taps.append(conv(taps[-1]))
    return out(torch.cat(taps[::-1], dim=1))


def mp_down(convs, x):
    """/2 merge: 1x1/3x3-s2 branch beside a 2x2 max pool + 1x1 branch.
    ``convs`` = (mp_cv, cv1, cv2)."""
    mp_cv, cv1, cv2 = convs
    return torch.cat([cv2(cv1(x)), mp_cv(F.max_pool2d(x, 2, 2))], dim=1)


class _Flat(nn.Module):
    """A scope of flat, reference-named convs."""

    def __init__(self, generator):
        super().__init__()
        self._g = generator

    def conv(self, name, cin, cout, k, s=1):
        setattr(self, name, ConvBnAct(cin, cout, k, s, padding=0 if k == 1 else None,
                                      generator=self._g))
        return getattr(self, name)

    def elan(self, prefix, first, cin, mid, out, half):
        """The seven convs of an ELAN named ``{prefix}{first}..{first + 6}``:
        two 1x1 entries at ``mid``, four 3x3 (``half``: the ELAN6 chain at
        mid/2), the 1x1 out conv over the concatenated taps."""
        n = iter(range(first, first + 7))
        ch = mid // 2 if half else mid
        convs = [self.conv(f"{prefix}{next(n)}", cin, mid, 1),
                 self.conv(f"{prefix}{next(n)}", cin, mid, 1)]
        cin_chain = mid
        for _ in range(4):
            convs.append(self.conv(f"{prefix}{next(n)}", cin_chain, ch, 3))
            cin_chain = ch
        taps = 2 * mid + 4 * ch if half else 4 * mid
        convs.append(self.conv(f"{prefix}{next(n)}", taps, out, 1))
        return tuple(convs)

    def down(self, prefix, cin, mid):
        """MPDown's convs ``{prefix}1..3``: mp_cv, cv1, cv2."""
        return (self.conv(f"{prefix}1", cin, mid, 1), self.conv(f"{prefix}2", cin, mid, 1),
                self.conv(f"{prefix}3", mid, mid, 3, 2))


class _Backbone(_Flat):
    def __init__(self, generator):
        super().__init__(generator)
        self.conv("stem", 3, 32, 3)
        self.b1 = (self.conv("backbone_stage1_conv1", 32, 64, 3, 2),
                   self.conv("backbone_stage1_conv2", 64, 64, 3))
        # tuples: the convs are registered once, under their reference names
        self.b2 = (self.conv("backbone_stage2_conv1", 64, 128, 3, 2),
                   self.elan("backbone_stage2_conv", 2, 128, 64, 256, False))
        self.stages = []
        for s, (cin, mid, emid, eout) in zip((3, 4, 5), ((256, 128, 128, 512),
                                                      (512, 256, 256, 1024),
                                                      (1024, 512, 256, 1024))):
            prefix = f"backbone_stage{s}_conv"
            self.stages.append((self.down(prefix, cin, mid),
                                self.elan(prefix, 4, 2 * mid, emid, eout, False)))
        del self._g  # a Generator does not deep-copy


class _Head(_Flat):
    def __init__(self, generator, deploy):
        super().__init__(generator)
        self.head_spp = CSPCSPP(1024, 512, generator=generator)
        p = "head_eelan{}_conv"
        self.h1 = (self.conv(p.format(1) + "1", 512, 256, 1),
                   self.conv(p.format(1) + "2", 1024, 256, 1),
                   self.elan(p.format(1), 3, 512, 256, 256, True))
        self.h2 = (self.conv(p.format(2) + "1", 256, 128, 1),
                   self.conv(p.format(2) + "2", 512, 128, 1),
                   self.elan(p.format(2), 3, 256, 128, 128, True))
        self.h3 = (self.down(p.format(3), 128, 128), self.elan(p.format(3), 4, 512, 256, 256, True))
        self.h4 = (self.down(p.format(4), 256, 256),
                   self.elan(p.format(4), 4, 1024, 512, 512, True))
        for i, (cin, cout) in enumerate(((128, 256), (256, 512), (512, 1024))):
            setattr(self, f"head_output_repconv{i + 1}",
                    RepConv(cin, cout, deploy=deploy, generator=generator))
        del self._g


class _Detect(nn.Module):
    def __init__(self, num_class, num_anchor, generator):
        super().__init__()
        no = num_anchor * (5 + num_class)
        for scale, ch, s in zip(V7_SCALES, (256, 512, 1024), (8, 16, 32)):
            conv = Conv2d(ch, no, 1)
            kaiming_fan_out_(conv.weight, generator)
            with torch.no_grad():
                conv.bias.copy_(v7_detect_bias(s, num_class, num_anchor))
            setattr(self, f"implicitadd_{scale}", ImplicitAdd(ch, generator))
            setattr(self, f"detect_{scale}", conv)
            setattr(self, f"implicitmul_{scale}", ImplicitMul(no, generator))

    def forward(self, feats):
        return [getattr(self, f"implicitmul_{s}")(getattr(self, f"detect_{s}")(
            getattr(self, f"implicitadd_{s}")(f))) for s, f in zip(V7_SCALES, feats)]


class YOLOv7(nn.Module):
    def __init__(self, num_class: int, num_anchor: int = 3,
                 generator: torch.Generator | None = None, dtype=torch.float32,
                 remat: bool = False, deploy: bool = False):
        super().__init__()
        self.num_class, self.num_anchor = num_class, num_anchor
        self.dtype, self.remat, self.deploy = dtype, remat, deploy
        self.backbone = _Backbone(generator)
        self.head = _Head(generator, deploy)
        self.detect = _Detect(num_class, num_anchor, generator)

    def _elan(self, fn, convs, x):
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(fn, convs, x, use_reentrant=False, context_fn=remat_context)
        return fn(convs, x)

    def forward(self, x: torch.Tensor):
        bb, hd = self.backbone, self.head
        x = x.to(self.dtype)
        x = bb.b2[0](bb.b1[1](bb.b1[0](bb.stem(x))))  # /4
        x = self._elan(elan4, bb.b2[1], x)
        routes = []
        for down, elan in bb.stages:  # /8, /16, /32
            x = self._elan(elan4, elan, mp_down(down, x))
            routes.append(x)
        r3, r4, _ = routes

        spp = hd.head_spp(x)  # /32
        lat, route, elan = hd.h1
        e1 = self._elan(elan6, elan, torch.cat([route(r4), upsample2x(lat(spp))], dim=1))
        lat, route, elan = hd.h2
        e2 = self._elan(elan6, elan, torch.cat([route(r3), upsample2x(lat(e1))], dim=1))  # /8
        down, elan = hd.h3
        e3 = self._elan(elan6, elan, torch.cat([mp_down(down, e2), e1], dim=1))  # /16
        down, elan = hd.h4
        e4 = self._elan(elan6, elan, torch.cat([mp_down(down, e3), spp], dim=1))  # /32
        feats = [hd.head_output_repconv1(e2), hd.head_output_repconv2(e3),
                 hd.head_output_repconv3(e4)]
        return self.detect(feats)
