"""How near the loader's workers are to setting the pace: the workers'
host ms a sample on the cell's path (``letterbox`` with augmentation closed,
``plan`` with it rendered on the card) x the images of an update, over the
workers x the ms of an update in the window, from the program's counters
(``data/loader.py``)."""

from port_bench.core import registry


def read(ctx):
    snap = registry.totals()
    path = "letterbox" if ctx["traffic"]["augmentation"] == "closed" else "plan"
    samples = registry.counter(snap, f"loader.samples.{path}")
    sample_ns = registry.counter(snap, f"loader.sample_ns.{path}")
    workers = registry.counter(snap, "loader.workers")
    if not samples or not sample_ns or not workers or not ctx.get("img_per_s"):
        return None
    images = ctx["traffic"]["hyp"]["accumulate_loss_step"]
    update_ms = 1e3 * images / ctx["img_per_s"]
    return 100.0 * (sample_ns / samples / 1e6) * images / (workers * update_ms)
