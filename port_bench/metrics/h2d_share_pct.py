"""Host-to-device copy time (``Evaluator._prepare``'s pageable uint8 copy)
over the device's busy time in the profiled window (``core/readers.py``)."""

from port_bench.core.readers import h2d_pct


def read(ctx):
    return h2d_pct(ctx)
