"""Host ms of the ``Trainer``'s ``train.h2d`` span an update (the pinned
buffer, the pack and the copy's launch; ``train/trainer.py``), from the
program's registry: the profiler off, the first batch of a shape
(``warmup.device_batch``) left out."""

from port_bench.core import registry


def read(ctx):
    return registry.span_ms(registry.totals(), "train.h2d")
