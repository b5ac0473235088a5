"""The render of the plans on the card (``data/device_aug.py::render_batch``
under the port's ``train.render`` range): the least time of each profiled
update's render (``core/roofline.py::render_bound_ms``) over the device's
busy time inside the range."""

from port_bench.core.readers import whole_summary


def read(ctx):
    s = whole_summary(ctx)
    bound_ms = sum(ctx.get("render_bound_ms", []))
    dev_us = 0.0 if s is None else s.ranges.get("train.render", 0.0)
    return 100.0 * bound_ms * 1e3 / dev_us if dev_us > 0 and bound_ms > 0 else None
