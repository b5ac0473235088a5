"""Run one benchmark cell and report what the port's tracing registry
(``yoloseries_tpu_torch/utils/trace.py``) and the profiled window saw.

The cell runs in this process through ``port_bench.run`` (its arguments
as there), so the registry's totals are the run's. The report, a JSON
object on the last line of standard output (``--out`` writes it to a file
too), holds:

* ``cost_ns``: the host cost of one ``span`` and one ``count`` with no
  profiler on, and of ``record_function`` with nothing recording;
* ``setup_s``: the ``setup.*`` and ``warmup.*`` spans' seconds, each with
  the span it ran in;
* ``spans``: per span name, the mean host ms with the profiler off (the
  first calls at a shape, inside ``warmup.*``, left out:
  ``port_bench/core/registry.py``) and on, the profiled calls, and the
  ratio of the two, the profiler's inflation;
* ``counters``: every counter;
* ``idle``: with ``--trace 1``, every idle gap of the last profiled window
  put down to the outermost host event at its middle, as
  ``port_bench/core/trace.py`` labels its 200 longest: seconds by label.

    python3 scripts/trace_report.py --workload yolox_s.serve_b16 --seed 7 --seconds 30 \
        --trace 1 --out report.json
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

N_COST = 100_000


def cost_ns():
    """ns a call, an empty loop's taken off, the best of 3."""
    import torch

    from yoloseries_tpu_torch.utils import trace

    def empty():
        for _ in range(N_COST):
            pass

    def spans():
        for _ in range(N_COST):
            with trace.span("cost.span"):
                pass

    def counts():
        for _ in range(N_COST):
            trace.count("cost.count")

    def ranges():
        for _ in range(N_COST):
            with torch.profiler.record_function("cost.range"):
                pass

    def best(fn):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter_ns()
            fn()
            runs.append(time.perf_counter_ns() - t0)
        return min(runs) / N_COST

    base = best(empty)
    out = {"span": best(spans) - base, "count": best(counts) - base,
           "record_function_off": best(ranges) - base}
    trace.reset()
    return out


def idle_split(prof):
    """{outermost host event's name: idle seconds} over every gap between
    the device's busy intervals in the profiled window, and the window."""
    from bisect import bisect_left

    from torch.autograd import DeviceType

    from port_bench.core.trace import WINDOW, _union

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    cpu_names = {e.name for e in cpu}
    win = next(e for e in cpu if e.name == WINDOW)
    w0, w1 = win.time_range.start, win.time_range.end
    busy = _union([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in events
                   if e.device_type == DeviceType.CUDA and e.name not in cpu_names
                   and "Activity Buffer" not in e.name and e.time_range.end > w0
                   and e.time_range.start < w1 and e.time_range.end > e.time_range.start])
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                  if e.name != WINDOW and w0 <= e.time_range.start <= w1)
    reach, top = [], float("-inf")  # the latest end of the events started so far
    for _, end, _ in host:
        top = max(top, end)
        reach.append(top)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    split = {}
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        i = bisect_left(reach, mid)  # the first event to reach the middle: the outermost
        label = host[i][2] if i < len(host) and host[i][0] <= mid else "host outside any op"
        split[label] = split.get(label, 0.0) + (e - s) / 1e6
    return dict(sorted(split.items(), key=lambda kv: -kv[1])), (w1 - w0) / 1e6


def report(totals):
    from port_bench.core import registry

    setup = [{"name": s["name"], "parent": s["parent"], "calls": s["calls"], "s": s["ns"] / 1e9}
             for s in totals["spans"] if s["name"].startswith(("setup.", "warmup."))]
    spans = {}
    for name in sorted({s["name"] for s in totals["spans"]}):
        on = [s for s in totals["spans"] if s["name"] == name and s["profiled"]]
        calls = sum(s["calls"] for s in on)
        on_ms = sum(s["ns"] for s in on) / calls / 1e6 if calls else None
        off_ms = registry.span_ms(totals, name)
        spans[name] = {"off_ms": off_ms, "on_calls": calls, "on_ms": on_ms,
                       "inflation": on_ms / off_ms if on_ms and off_ms else None}
    return {"setup_s": setup, "spans": spans, "counters": totals["counters"]}


def main(argv):
    out_path = None
    if "--out" in argv:
        i = argv.index("--out")
        out_path, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    from port_bench import run
    from port_bench.core import trace as window
    from yoloseries_tpu_torch.utils import trace

    run.T0 = T_START  # set-up counts from the start, as in a run of its own
    seen = {}
    summarize = window.summarize

    def keep(prof):  # the last profiled window is the one kept
        split, window_s = idle_split(prof)
        seen["idle"] = {"window_s": window_s, "idle_s": sum(split.values()),
                        "by_outer_s": split}
        return summarize(prof)

    window.summarize = keep
    rc = run.main(argv)
    totals = trace.totals()
    line = {"rc": rc, "cost_ns": cost_ns(), **report(totals), **seen}
    text = json.dumps(line)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(text + "\n")
    print(text, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
