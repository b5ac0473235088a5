"""Box math, letterbox, preprocess and NMS on tensors.

Import the submodules directly (``ops.nms``, ``ops.iou``, ...): the kernel
modules import ``ops.iou``, so this package imports nothing itself.
"""
