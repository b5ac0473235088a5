"""The port's one tracing mechanism: named spans and counters, kept as
process-wide aggregates.

``span(name)`` times a block on the host clock and, while a
``torch.profiler`` records in this thread, opens ``record_function(name)``
too: the range lands on the profiler's clock, and is mirrored onto the
device, so a profile's device work and idle gaps can be put down to the
span the host was in. With no profiler on, ``record_function`` is skipped
(it costs ~10 us a call even when nothing records); a span then costs two
clock reads and one update of the totals.

The totals are kept per (name, the enclosing span's name or None, whether a
profiler recorded): calls, host ns, and self ns (the duration less that of
the spans directly inside it). A reader can so take a profiled window apart
from an unprofiled one, and the first calls at a new shape (the ``warmup.*``
spans) apart from the rest. ``count(name, n)`` adds to a counter of the
same registry. No timestamped log is kept: the profiler is the timestamped
record.

``totals()`` returns a plain-dict snapshot; ``reset()`` clears both.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext

import torch

__all__ = ["count", "reset", "span", "totals", "warmup"]

_lock = threading.Lock()
_spans: dict = {}  # (name, parent, profiled) -> [calls, ns, self_ns]
_counters: dict = {}  # name -> int
_local = threading.local()  # .stack: the open spans of this thread


class span:
    """Context manager: time the block under ``name`` (see the module)."""

    __slots__ = ("name", "_parent", "_range", "_t0", "_child_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._parent = stack[-1] if stack else None
        stack.append(self)
        self._child_ns = 0
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        profiled = self._range is not None
        if profiled:
            self._range.__exit__(*exc)
            self._range = None
        _local.stack.pop()
        parent = self._parent
        if parent is not None:
            parent._child_ns += ns
        key = (self.name, None if parent is None else parent.name, profiled)
        with _lock:
            entry = _spans.get(key)
            if entry is None:
                entry = _spans[key] = [0, 0, 0]
            entry[0] += 1
            entry[1] += ns
            entry[2] += ns - self._child_ns
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def warmup(name: str, seen: set, key):
    """``span(name)`` the first time ``key`` enters ``seen`` (counted under
    ``warmup.shapes``), else a no-op context: wraps the first call at each
    shape, in which cuDNN autotunes and the allocator grows."""
    if key in seen:
        return nullcontext()
    seen.add(key)
    count("warmup.shapes")
    return span(name)


def totals() -> dict:
    """{"spans": [{name, parent, profiled, calls, ns, self_ns}, ...],
    "counters": {name: n}}: a snapshot of the registry."""
    with _lock:
        spans = [{"name": name, "parent": parent, "profiled": profiled, "calls": calls,
                  "ns": ns, "self_ns": self_ns}
                 for (name, parent, profiled), (calls, ns, self_ns) in _spans.items()]
        return {"spans": spans, "counters": dict(_counters)}


def reset() -> None:
    """Clear every span total and counter."""
    with _lock:
        _spans.clear()
        _counters.clear()
