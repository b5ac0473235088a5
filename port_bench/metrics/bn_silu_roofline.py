"""K1 (``kernels/bn_silu.py``, ``csrc/bn_silu.cu``): the least time of the
profiled calls' BN + SiLU epilogues (``core/roofline.py::bn_silu_bound_ms``
at the cell's batch and size, once a call) over the device time of
``bn_silu_kernel`` in the profiled window."""

from port_bench.core.readers import whole_summary
from port_bench.core.roofline import bn_silu_bound_ms


def read(ctx):
    s = whole_summary(ctx)
    dev_us = 0.0 if s is None else s.device_us("bn_silu_kernel")
    if dev_us <= 0 or not ctx["traced"]:
        return None
    t = ctx["traffic"]
    bound_ms = bn_silu_bound_ms(ctx["cfg"], t["batch"], t["image_size"]) * len(ctx["traced"])
    return 100.0 * bound_ms * 1e3 / dev_us
