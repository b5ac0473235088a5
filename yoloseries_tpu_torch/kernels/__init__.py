"""Hand-written CUDA kernels (sources in ``../csrc``) with their plain
PyTorch twins and launch counters.

* ``nms_greedy.nms_greedy``: greedy NMS as one ordered tile scan, input in
  any order, K <= 8192.
* ``nms_matrix.matrix_nms``: greedy NMS as a suppression-bitmask fixpoint,
  K <= 1024; ``nms_matrix.matrix_nms_chunked`` drives it at any K.
* ``bn_silu.bn_silu``: the eval-mode BN affine and SiLU of ``ConvBnAct`` in
  one pass over an f32 or bf16 NCHW tensor.

Nothing is compiled at import: ``_build.load()`` builds the library at the
first launch on a CUDA tensor.
"""
