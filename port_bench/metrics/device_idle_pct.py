"""Share of the profiled window (whole calls) in which no kernel, copy or
set ran on the card (``core/readers.py``)."""

from port_bench.core.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
