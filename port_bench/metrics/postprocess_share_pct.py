"""The serving call's post-processing share of the device: the busy time
inside the device spans of the ``Evaluator``'s ``eval.select`` (decode and
candidate selection) and ``eval.nms`` (NMS, merge, the family's quirks)
ranges over the busy time of the profiled window."""

from port_bench.core.readers import whole_summary


def read(ctx):
    s = whole_summary(ctx)
    post = 0.0 if s is None else s.ranges.get("eval.select", 0.0) + s.ranges.get("eval.nms", 0.0)
    return 100.0 * post / s.busy_us if post > 0 else None
