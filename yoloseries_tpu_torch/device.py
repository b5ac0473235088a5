"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A missing
card is an error, never a quiet fall back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_numeric_mode"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for (or
    implied) and no card is visible. ``"cpu"`` is honoured as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def set_numeric_mode() -> None:
    """The numeric mode every entry point runs in, and every card number of
    the port was taken in: f32 convolutions and matmuls without TF32, and
    cuDNN's autotuner picking each convolution's algorithm at first use.
    Without it PyTorch's defaults would run cuDNN convolutions in TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
