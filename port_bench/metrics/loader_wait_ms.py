"""Host time the update body waits in ``next(train_loader)`` (the worker
processes and producer thread of ``data/loader.py``), the mean an update
over the window."""


def read(ctx):
    return ctx["loader_wait_ms"]
