"""The median batch latency of the window, from the call to the detections
on the host: a steadier statistic beside the end-to-end 95th percentile."""


def read(ctx):
    return ctx["p50_ms"]
