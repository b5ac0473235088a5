"""Host seconds of set-up spent in the program's first calls at each new
shape (the ``warmup.*`` spans: cuDNN's autotune, the allocator's growth,
the kernels' build), from the program's registry."""

from port_bench.core import registry


def read(ctx):
    return registry.warmup_s(registry.totals())
