"""The reduction of a profiled window (``core/trace.py``) on a fixed set of
events: busy time as a union, copies apart, the program's ranges, coverage
and the idle gaps' labels."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from port_bench.core import trace


def _ev(name, start, end, device):
    kind = DeviceType.CUDA if device else DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=start, end=end))


def _prof():
    events = [
        _ev(trace.WINDOW, 0.0, 100.0, False),
        _ev("aten::to", 0.0, 20.0, False),
        _ev("cudaMemcpyAsync", 1.0, 19.0, False),
        _ev("cudaLaunchKernel", 21.0, 22.0, False),
        _ev("cudaLaunchKernel", 22.0, 23.0, False),
        _ev("yolox_loss.assign", 20.0, 30.0, False),
        _ev("Memcpy HtoD (Pageable -> Device)", 10.0, 20.0, True),
        _ev("kernel_a", 25.0, 45.0, True),
        _ev("kernel_b", 40.0, 50.0, True),  # overlaps kernel_a: counted once
        _ev("yolox_loss.assign", 25.0, 60.0, True),  # the range mirrored on the device
    ]
    return SimpleNamespace(events=lambda: events)


def test_summary():
    s = trace.summarize(_prof())
    assert s.window_us == 100.0
    assert s.busy_us == 10.0 + 25.0  # [10, 20] and [25, 50]
    assert (s.kernels, s.launches, s.whole) == (2, 2, True)
    assert s.device_us("Memcpy HtoD") == 10.0
    assert s.ranges == {"yolox_loss.assign": 25.0}  # busy inside [25, 60]
    gaps = dict(s.gaps)
    assert gaps["aten::to > cudaMemcpyAsync"] == 10.0  # [0, 10]
    assert gaps["host outside any op"] == 50.0  # [50, 100]
    out = s.breakdown()
    assert out["device_ops"][0] == ["kernel_a", 20.0 / 1e6]
    assert out["idle_gaps"][0] == ["host outside any op", 50.0 / 1e6]
