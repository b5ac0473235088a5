"""The whole serving call's share of the card's f32 peak (``core/readers.py``),
from the images served a second in the window."""

from port_bench.core.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, 1)
