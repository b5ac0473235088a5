"""Host ms of the ``Evaluator``'s ``eval.prepare`` span (the pageable H2D
copy, /255, NHWC to NCHW; ``evaluation/yolov5.py``) a call, from the
program's registry: the calls with the profiler off, the first call at a
shape (``warmup.eval``) left out."""

from port_bench.core import registry


def read(ctx):
    return registry.span_ms(registry.totals(), "eval.prepare")
