"""What the per-layer metrics read from the program's own tracing registry
(``yoloseries_tpu_torch/utils/trace.py``): span totals and counters, kept
in this process while the cell ran. Each function returns None where the
program has no registry (a version before it) or the span or counter is
absent."""

from __future__ import annotations

import importlib


def totals():
    """The registry's snapshot, or None where the program has none."""
    try:
        trace = importlib.import_module("yoloseries_tpu_torch.utils.trace")
    except ImportError:
        return None
    return trace.totals()


def _warmup(name) -> bool:
    return name is not None and name.startswith("warmup.")


def span_ms(snap, name: str):
    """Host ms a call of span ``name`` with the profiler off and not
    directly inside a ``warmup.*`` span (the first call at a new shape)."""
    if snap is None:
        return None
    calls = ns = 0
    for s in snap["spans"]:
        if s["name"] == name and not s["profiled"] and not _warmup(s["parent"]):
            calls += s["calls"]
            ns += s["ns"]
    return ns / calls / 1e6 if calls else None


def warmup_s(snap):
    """Host seconds in the outermost ``warmup.*`` spans."""
    if snap is None:
        return None
    spans = [s for s in snap["spans"] if _warmup(s["name"]) and not _warmup(s["parent"])]
    return sum(s["ns"] for s in spans) / 1e9 if spans else None


def counter(snap, name: str):
    """The counter's value, or None where it was never counted."""
    return None if snap is None else snap["counters"].get(name)
