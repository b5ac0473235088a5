"""The share of the assigner's (gt slot x cell) lattice that works on
padding: 100 x (1 - valid boxes / gt slots) over every batch the
``Trainer`` copied to the card, from the program's counters
``train.gt_boxes`` and ``train.gt_slots`` (``Trainer._device_batch``,
counted from the host's labels)."""

from port_bench.core import registry


def read(ctx):
    snap = registry.totals()
    slots = registry.counter(snap, "train.gt_slots")
    boxes = registry.counter(snap, "train.gt_boxes")
    return 100.0 * (1.0 - boxes / slots) if slots and boxes is not None else None
