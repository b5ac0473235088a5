"""The whole training update's share of the card's f32 peak
(``core/readers.py``): 3 x the forward FLOPs an image, from the images
trained a second in the window."""

from port_bench.core.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, 3)
