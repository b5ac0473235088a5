"""PyTorch/CUDA port of yoloseries_tpu for NVIDIA Hopper.

The JAX package beside it is the reference; this package imports none of it.
Module layout and names mirror ``yoloseries_tpu`` so each counterpart is
easy to find. The NMS kernels are CUDA C++ under ``csrc/``, built with
``nvcc`` at first use (``kernels/_build.py``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
