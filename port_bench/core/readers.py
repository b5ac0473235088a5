"""What several per-layer metrics read alike: the whole step's share of the
f32 peak, the device's idle share, the H2D copy's share of its busy time
and an NMS kernel's roofline share. Each returns None where the run has
nothing to read."""

from __future__ import annotations

from .flops import forward_flops
from .roofline import FP32_FLOP_PER_S, nms_bound_ms


def mfu_pct(ctx, passes: int) -> float:
    """``passes`` x the reference model's forward FLOPs an image at the
    cell's size (1 serving; 3 training: forward and backward, nothing
    recomputed) x the window's images a second, over 67 TFLOP/s."""
    flops = forward_flops(ctx["cfg"], ctx["traffic"]["image_size"])
    return 100.0 * passes * flops * ctx["img_per_s"] / FP32_FLOP_PER_S


def whole_summary(ctx):
    """The profiled window's summary where its coverage is whole, else None."""
    s = ctx["summary"]
    return s if s is not None and s.whole and s.busy_us > 0 else None


def idle_pct(ctx):
    """Share of the profiled window with no kernel, copy or set on the card."""
    s = whole_summary(ctx)
    return None if s is None else 100.0 * (1.0 - s.busy_us / s.window_us)


def h2d_pct(ctx):
    """``Memcpy HtoD`` device time over the device's busy time."""
    s = whole_summary(ctx)
    h2d = 0.0 if s is None else s.device_us("Memcpy HtoD")
    return 100.0 * h2d / s.busy_us if h2d > 0 else None


def roofline_pct(ctx, kernels):
    """100 x (the calls' least time) / (the named kernels' device time), or
    None where the window is not whole or the kernels did not run."""
    s, t = whole_summary(ctx), ctx["traffic"]
    if s is None:
        return None
    dev_us = s.device_us(*kernels)
    if dev_us <= 0:
        return None
    bound_ms = sum(nms_bound_ms(t["batch"], t["num_candidates"], t["max_keep"],
                                ctx["nms_ious"][j]) for j in ctx["traced"])
    return 100.0 * bound_ms * 1e3 / dev_us
