"""The assigner's share of the update: the device's busy time inside the
device spans of the port's ``<family>_loss.assign`` range (``losses/``; the
family is the configuration's) over its busy time in the profiled training
window."""

from port_bench.core.readers import whole_summary


def read(ctx):
    s = whole_summary(ctx)
    assign = 0.0 if s is None else s.ranges.get(f"{ctx['cfg']['family']}_loss.assign", 0.0)
    return 100.0 * assign / s.busy_us if assign > 0 else None
