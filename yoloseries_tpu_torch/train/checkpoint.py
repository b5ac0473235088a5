"""Checkpoints of the whole ``TrainState``; counterpart of
``yoloseries_tpu/train/checkpoint.py``.

Layout: ``ckpt_dir/<step>/state.pt`` (``torch.save`` of the model
``state_dict``, the optimizer state, the EMA, its count, the balances and
the step) and ``ckpt_dir/<step>/hyp.json`` (the JSON-able hyp entries), the
newest ``keep`` steps kept. ``restore_weights`` loads a checkpoint's EMA
(or raw) weights into a model for the ``val`` and ``detect`` entry points.
Loading the JAX package's Orbax checkpoints needs JAX and is not done here
(ROADMAP A10).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_weights", "latest_step"]


def _json_ok(v) -> bool:
    return isinstance(v, (int, float, str, bool, type(None), list, tuple))


def _steps(ckpt_dir: Path) -> list:
    if not ckpt_dir.exists():
        return []
    return sorted(int(p.name) for p in ckpt_dir.iterdir()
                  if p.name.isdigit() and (p / "state.pt").exists())


def save_checkpoint(ckpt_dir, state, step: int, hyp: dict | None = None, keep: int = 3):
    ckpt_dir = Path(ckpt_dir).absolute()
    out = ckpt_dir / str(int(step))
    out.mkdir(parents=True, exist_ok=True)
    torch.save({
        "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "ema": state.ema,
        "ema_count": state.ema_count,
        "balances": state.balances,
    }, out / "state.pt")
    if hyp is not None:
        (out / "hyp.json").write_text(json.dumps({k: v for k, v in hyp.items() if _json_ok(v)}))
    for old in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(ckpt_dir / str(old))


def latest_step(ckpt_dir) -> int | None:
    steps = _steps(Path(ckpt_dir).absolute())
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir, state, step: int | None = None):
    """Load ``step`` (default: the newest) into ``state`` in place; returns
    (state, step), step None when there is no checkpoint."""
    ckpt_dir = Path(ckpt_dir).absolute()
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return state, None
    dev = state.balances.device
    saved = torch.load(ckpt_dir / str(int(step)) / "state.pt", map_location=dev,
                       weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    for k, v in saved["ema"].items():
        state.ema[k].copy_(v)
    state.ema_count = float(saved["ema_count"])
    state.balances = saved["balances"].to(dev)
    state.step = int(saved["step"])
    return state, step


def restore_weights(model, ckpt_dir, params: str = "ema", device=None):
    """Build a train state around ``model`` (on ``device``), restore the
    newest checkpoint of ``ckpt_dir`` into it and leave ``model`` holding
    its EMA weights (``params="ema"``) or its trained ones (``"raw"``).
    Returns the step, None when there is no checkpoint."""
    from .optim import OptimizerConfig
    from .state import create_train_state

    if params not in ("ema", "raw"):
        raise ValueError(f"params {params!r}: 'ema' or 'raw'")
    state, step = restore_checkpoint(
        ckpt_dir, create_train_state(model, OptimizerConfig(), device=device))
    if step is not None and params == "ema":
        model.load_state_dict(state.ema)
    return step
