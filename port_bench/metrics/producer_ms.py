"""Host ms the loader's producer thread spends on a batch outside the
workers' map (the collate, in the trainer's own process;
``data/loader.py``), from the program's counters."""

from port_bench.core import registry


def read(ctx):
    snap = registry.totals()
    batches = registry.counter(snap, "loader.batches")
    ns = registry.counter(snap, "loader.batch_ns")
    return ns / batches / 1e6 if batches and ns else None
