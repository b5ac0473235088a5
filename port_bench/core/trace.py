"""Reduce a ``torch.profiler`` window to what the per-layer metrics read.

The profiled calls run inside the harness's own span ``WINDOW``; its CPU
event gives the window on the profiler's clock. Device events are kernels,
copies and sets; ``record_function`` ranges mirrored onto the device are
left out of them (their names are CPU event names too), since they span
kernels already counted; each range's device span gives the busy time
inside it. Busy time is the union of the device intervals, so
overlapping streams are not counted twice.

Coverage: the profiler has been seen to drop device records in a process
that ran for minutes. ``coverage`` is the kernel records kept over the
CPU-side launch records; a reader of device times is given the summary
only where coverage is whole (``Summary.whole``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

WINDOW = "port_bench.window"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel")
TOP = 10
LABELLED = 200  # the longest idle gaps given a label


@dataclass
class Summary:
    window_us: float
    busy_us: float
    launches: int
    kernels: int
    device: list = field(default_factory=list)  # (name, start_us, end_us)
    gaps: list = field(default_factory=list)  # (label, us)
    ranges: dict = field(default_factory=dict)  # record_function range -> device busy us

    @property
    def coverage(self) -> float:
        return self.kernels / max(self.launches, 1)

    @property
    def whole(self) -> bool:
        return self.launches > 0 and self.kernels >= self.launches

    def device_us(self, *subs) -> float:
        """Device time of the events whose name holds any of ``subs``."""
        return sum(e - s for n, s, e in self.device if any(x in n for x in subs))

    def breakdown(self) -> dict:
        by_name = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = {}
        for label, us in self.gaps:
            gaps[label] = gaps.get(label, 0.0) + us
        top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:120], us / 1e6] for n, us in top],
                "idle_gaps": [[n[:120], us / 1e6] for n, us in top_gaps]}


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof) -> Summary:
    from torch.autograd import DeviceType

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    cpu_names = {e.name for e in cpu}
    win = [e for e in cpu if e.name == WINDOW]
    if not win:
        raise RuntimeError(f"the profile holds no {WINDOW} span")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == DeviceType.CUDA and e.name not in cpu_names
           and "Activity Buffer" not in e.name and e.time_range.end > e.time_range.start]
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in dev if e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e in dev])
    ranges = {}
    for e in events:  # the device busy time inside each span of the program's ranges
        if (e.device_type == DeviceType.CUDA and e.name in cpu_names and e.name != WINDOW
                and w0 <= e.time_range.start <= w1):
            s0, s1 = e.time_range.start, e.time_range.end
            inside = sum(max(0.0, min(b1, s1) - max(b0, s0)) for b0, b1 in busy)
            ranges[e.name] = ranges.get(e.name, 0.0) + inside
    launches = sum(e.name in LAUNCHES for e in cpu if w0 <= e.time_range.start <= w1)
    kernels = sum(not n.startswith(("Memcpy", "Memset")) for n, _, _ in dev)
    # idle gaps, each labelled by what the host was in at its middle: the
    # outermost and the innermost CPU event there
    inner = [e for e in cpu if e.name != WINDOW and w0 <= e.time_range.start <= w1]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    spans = sorted(((s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s),
                   key=lambda se: se[0] - se[1])[:LABELLED]
    gaps = []
    for s, e in spans:
        mid = (s + e) / 2
        around = sorted((ev for ev in inner if ev.time_range.start <= mid <= ev.time_range.end),
                        key=lambda ev: ev.time_range.start)
        if not around:
            label = "host outside any op"
        elif len(around) == 1:
            label = around[0].name
        else:
            label = f"{around[0].name} > {around[-1].name}"
        gaps.append((label, e - s))
    return Summary(window_us=w1 - w0, busy_us=sum(e - s for s, e in busy), launches=launches,
                   kernels=kernels, device=dev, gaps=gaps, ranges=ranges)


def profile_calls(call, n, log):
    """Profile ``n`` calls of ``call`` (each ending in a host sync) inside
    the ``WINDOW`` span. Where coverage is short the window is halved, up
    to three times. Returns (summary, calls made in the kept window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    summary = None
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                t0 = time.perf_counter()
                made = [call() for _ in range(n)]
                torch.cuda.synchronize()
                host_s = time.perf_counter() - t0
        summary = summarize(prof)
        log(f"trace: {n} calls, {host_s:.3f} s host, {summary.kernels} kernel records of "
            f"{summary.launches} launches (coverage {summary.coverage:.4f}), device busy "
            f"{summary.busy_us / 1e6:.4f} s of {summary.window_us / 1e6:.4f} s")
        if summary.whole or n == 1:
            return summary, made
        n = max(n // 2, 1)
    return summary, made
