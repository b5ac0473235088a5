"""B2 (``kernels/nms_matrix.py``: ``csrc/nms_relation.cu`` then
``csrc/nms_matrix.cu``): the least time of each profiled call's NMS over the
device time of the relation and fixpoint kernels."""

from port_bench.core.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("nms_relation_kernel", "nms_fixpoint_kernel"))
