"""Checkpoints of the whole ``TrainState``; counterpart of
``yoloseries_tpu/train/checkpoint.py``.

Two layouts of a step directory ``ckpt_dir/<step>`` are read; the step's
own files say which, and the newest step of either wins:

* the port's: ``state.pt`` (``torch.save`` of the model ``state_dict``, the
  optimizer state, the EMA, its count, the balances and the step) and
  ``hyp.json`` (the JSON-able hyp entries). ``save_checkpoint`` writes this
  one, and its ``keep`` pruning removes only such steps;
* the JAX package's Orbax step (``_CHECKPOINT_METADATA``, ``state/``,
  ``hyp/``), read without JAX through ``utils/orbax.py``: ``params`` and
  ``batch_stats`` become the model's ``state_dict`` and ``ema_params`` and
  ``ema_batch_stats`` the EMA (``utils/weights.py::state_dict_from_jax``),
  the optax state the optimizer's (``optim.py::optimizer_state_from_jax``),
  and ``step``, ``ema_count`` and ``balances`` are carried as they are.

``restore_weights`` loads a checkpoint's EMA (or raw) weights into a model
for the ``val`` and ``detect`` entry points; from an Orbax step it reads
only those two trees.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from ..utils import orbax
from ..utils.weights import state_dict_from_jax

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_weights", "latest_step"]


def _json_ok(v) -> bool:
    return isinstance(v, (int, float, str, bool, type(None), list, tuple))


def _port_steps(ckpt_dir: Path) -> list:
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
    for old in _port_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(ckpt_dir / str(old))


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir).absolute()
    steps = _port_steps(ckpt_dir) + orbax.steps(ckpt_dir)
    return max(steps) if steps else None


def _step_dir(ckpt_dir: Path, step: int) -> tuple:
    """(directory, "port" or "orbax") of a step."""
    path = ckpt_dir / str(int(step))
    if (path / "state.pt").exists():
        return path, "port"
    if orbax.is_orbax_step(path):
        return path, "orbax"
    raise FileNotFoundError(f"no checkpoint of step {step} under {ckpt_dir}")


def _model_state(model, params: dict, batch_stats: dict) -> dict:
    """JAX trees -> ``model``'s ``state_dict`` (a 6x6 stem kernel mapped to
    a model built with ``s2d_stem=True``, as ``load_blob_weights`` does)."""
    from ..nn.deploy import fold_stem_to_s2d

    sd = state_dict_from_jax(params, batch_stats)
    if any(getattr(m, "s2d_stem", False) for m in model.modules()):
        sd = fold_stem_to_s2d(sd)
    return sd


def _restore_orbax(step_dir: Path, state):
    from .optim import optimizer_state_from_jax

    tree = orbax.read_tree(step_dir)
    dev = state.balances.device
    model = state.model
    model.load_state_dict(_model_state(model, tree["params"], tree["batch_stats"]))
    ema = _model_state(model, tree["ema_params"], tree["ema_batch_stats"])
    if set(ema) != set(state.ema):
        raise KeyError(f"{step_dir}: EMA names differ from the model's: "
                       f"{sorted(set(ema) ^ set(state.ema))[:5]}")
    for k, v in ema.items():
        state.ema[k].copy_(v)
    state.optimizer.load_state_dict(
        optimizer_state_from_jax(tree["opt_state"], state.optimizer, model, tree["params"]))
    state.ema_count = float(tree["ema_count"])
    state.balances = torch.as_tensor(tree["balances"], dtype=torch.float32).to(dev)
    state.step = int(tree["step"])


def restore_checkpoint(ckpt_dir, state, step: int | None = None):
    """Load ``step`` (default: the newest of either layout) into ``state``
    in place; returns (state, step), step None when there is no
    checkpoint."""
    ckpt_dir = Path(ckpt_dir).absolute()
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return state, None
    path, layout = _step_dir(ckpt_dir, step)
    if layout == "orbax":
        _restore_orbax(path, state)
        return state, step
    dev = state.balances.device
    saved = torch.load(path / "state.pt", map_location=dev, weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    for k, v in saved["ema"].items():
        state.ema[k].copy_(v)
    state.ema_count = float(saved["ema_count"])
    state.balances = saved["balances"].to(dev)
    state.step = int(saved["step"])
    return state, step


def restore_weights(model, ckpt_dir, params: str = "ema", device=None):
    """Restore the newest checkpoint of ``ckpt_dir`` (either layout) into
    ``model`` (moved to ``device``): its EMA weights (``params="ema"``) or
    its trained ones (``"raw"``). Returns the step, None when there is no
    checkpoint."""
    from .optim import OptimizerConfig
    from .state import create_train_state

    if params not in ("ema", "raw"):
        raise ValueError(f"params {params!r}: 'ema' or 'raw'")
    ckpt_dir = Path(ckpt_dir).absolute()
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    path, layout = _step_dir(ckpt_dir, step)
    if layout == "orbax":
        names = ("ema_params", "ema_batch_stats") if params == "ema" else ("params",
                                                                           "batch_stats")
        tree = orbax.read_tree(path, keys=names)
        model.load_state_dict(_model_state(model, *(tree.get(n, {}) for n in names)))
        if device is not None:
            model.to(device)
        return step
    state, step = restore_checkpoint(
        ckpt_dir, create_train_state(model, OptimizerConfig(), device=device), step)
    if params == "ema":
        model.load_state_dict(state.ema)
    return step
