"""Model summary and the config table; counterpart of
``yoloseries_tpu/utils/summary.py``.

``summarize_model`` counts the parameters and their bytes exactly as the
JAX package does (every parameter; BN running statistics are buffers, as
they are ``batch_stats`` there, and count in neither). The FLOPs are
counted by another rule, so the two numbers are near but not equal: JAX's
come from XLA's cost analysis of the compiled (fused) forward; here
``torch.utils.flop_counter`` counts the convolutions and matmuls alone, 2
FLOPs a multiply-add, with no elementwise op, on the meta device, so
nothing is computed or allocated on the model's device.
"""

from __future__ import annotations

import copy

import torch

__all__ = ["summarize_model", "format_hyp_table"]


def summarize_model(model: torch.nn.Module, input_shape=(1, 3, 640, 640)) -> dict:
    """{'params': N, 'param_bytes': bytes, 'gflops': forward GFLOPs of the
    convolutions and matmuls at ``input_shape`` (NCHW)}."""
    from torch.utils.flop_counter import FlopCounterMode

    params = list(model.parameters())
    meta = copy.deepcopy(model).to("meta").eval()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        meta(torch.zeros(input_shape, device="meta", dtype=params[0].dtype))
    return {
        "params": sum(p.numel() for p in params),
        "param_bytes": sum(p.numel() * p.element_size() for p in params),
        "gflops": counter.get_total_flops() / 1e9,
    }


def format_hyp_table(hyp: dict, title: str = "config") -> str:
    """Box-drawing table of hyperparameters."""
    items = [(str(k), str(v)) for k, v in sorted(hyp.items())]
    if not items:
        return f"{title}: (empty)"
    kw = max(max(len(k) for k, _ in items), len(title))
    vw = max(min(max(len(v) for _, v in items), 60), 5)
    sep = "+" + "-" * (kw + 2) + "+" + "-" * (vw + 2) + "+"
    lines = [sep, f"| {title:<{kw}} | {'value':<{vw}} |", sep]
    for k, v in items:
        lines.append(f"| {k:<{kw}} | {v[:vw]:<{vw}} |")
    lines.append(sep)
    return "\n".join(lines)
