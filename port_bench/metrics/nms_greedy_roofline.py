"""B1 (``kernels/nms_greedy.py``, ``csrc/nms_greedy.cu``): the least time of
each profiled call's NMS (``core/roofline.py::nms_bound_ms`` on the IoUs its
inputs need) over the kernel's device time."""

from port_bench.core.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("greedy_nms_kernel",))
