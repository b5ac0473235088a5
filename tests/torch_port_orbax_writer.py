"""A numpy-and-json writer of one Orbax checkpoint step in the plain-file
layout (``use_ocdbt: false``), as the JAX package's ``restore_checkpoint``
reads it: ``_CHECKPOINT_METADATA``, ``hyp/metadata``, ``state/_METADATA``
and one zarr v2 array per leaf (``state/<path joined by .>/.zarray`` and
its chunks), each chunk a zstd frame of raw blocks. For the tests of the
port's reader and ``chip_smoke.py``'s phase 15, on machines without JAX,
orbax or zstandard.

    write_step(ckpt_dir, 7, tree, hyp={"batch_size": 64})

``tree`` is nested dicts: leaves are numpy arrays (or numpy scalars) or
``None`` (a masked optimizer leaf or an empty state); a key that is a
digit string is a sequence index (a tuple's element in the JAX tree).
``yolov5_train_state_tree`` builds the JAX ``TrainState`` tree of a port
YOLOv5 train state (SGD).
"""

from __future__ import annotations

import json
import math
import shutil
import time
from itertools import product
from pathlib import Path

import numpy as np

__all__ = ["write_step", "zstd_raw_frame", "yolov5_jax_trees", "yolov5_train_state_tree"]

_HANDLERS = {
    "state": "orbax.checkpoint._src.handlers.standard_checkpoint_handler."
             "StandardCheckpointHandler",
    "hyp": "orbax.checkpoint._src.handlers.json_checkpoint_handler.JsonCheckpointHandler",
}
_BLOCK = 1 << 17


def zstd_raw_frame(data: bytes) -> bytes:
    """One zstd frame holding ``data`` in raw blocks (single segment, the
    content size in 8 bytes, no checksum)."""
    out = [(0xFD2FB528).to_bytes(4, "little"), bytes([0xE0]), len(data).to_bytes(8, "little")]
    starts = range(0, max(len(data), 1), _BLOCK)
    for i, s in enumerate(starts):
        part = data[s:s + _BLOCK]
        last = int(i == len(starts) - 1)
        out += [((len(part) << 3) | last).to_bytes(3, "little"), part]
    return b"".join(out)


def _zarr_dtype(a: np.ndarray) -> str:
    return a.dtype.str  # '<f4', '<i4', '|b1', ...


def _write_array(root: Path, name: str, a: np.ndarray, chunk_bytes: int | None):
    a = np.asarray(a, order="C")  # (ascontiguousarray makes a 0-d array 1-d)
    chunks = list(a.shape)
    if chunk_bytes and a.ndim and a.nbytes > chunk_bytes:  # halve the leading dims
        while math.prod(chunks) * a.itemsize > chunk_bytes:
            i = max(range(len(chunks)), key=lambda d: chunks[d])
            if chunks[i] == 1:
                break
            chunks[i] = -(-chunks[i] // 2)
    d = root / name
    d.mkdir(parents=True)
    (d / ".zarray").write_text(json.dumps({
        "chunks": chunks, "compressor": {"id": "zstd", "level": 1},
        "dimension_separator": ".", "dtype": _zarr_dtype(a), "fill_value": None,
        "filters": None, "order": "C", "shape": list(a.shape), "zarr_format": 2},
        separators=(",", ":")))
    grid = [-(-s // c) for s, c in zip(a.shape, chunks)]
    for idx in (product(*map(range, grid)) if a.ndim else [()]):
        block = np.zeros(chunks, a.dtype)  # an edge chunk is stored full size
        src = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, a.shape))
        block[tuple(slice(0, t.stop - t.start) for t in src)] = a[src]
        key = ".".join(map(str, idx)) if idx else "0"
        (d / key).write_bytes(zstd_raw_frame(block.tobytes()))


def _leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def write_step(ckpt_dir, step: int, tree: dict, hyp: dict | None = None,
               chunk_bytes: int | None = None) -> Path:
    """Write ``tree`` (and ``hyp``) as step ``step`` under ``ckpt_dir``;
    returns the step's directory. ``chunk_bytes``: split arrays larger than
    that into chunks (as orbax's ``chunk_byte_size``). Written in a
    temporary directory and renamed when complete, as orbax does."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / str(int(step))
    tmp = ckpt_dir / f"{int(step)}.orbax-checkpoint-tmp-{time.time_ns()}"
    state = tmp / "state"
    state.mkdir(parents=True)
    meta = {}
    for path, value in _leaves(tree):
        keys = [{"key": k, "key_type": 1 if k.isdigit() else 2} for k in path]
        if value is None:
            vm = {"value_type": "None", "skip_deserialize": True}
        else:
            value = np.asarray(value)
            _write_array(state, ".".join(path), value, chunk_bytes)
            vm = {"value_type": "jax.Array", "skip_deserialize": False,
                  "write_shape": list(value.shape)}
        meta[str(path)] = {"key_metadata": keys, "value_metadata": vm}
    (state / "_METADATA").write_text(json.dumps({
        "tree_metadata": meta, "use_ocdbt": False, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
    handlers = {"state": _HANDLERS["state"]}
    if hyp is not None:
        (tmp / "hyp").mkdir()
        (tmp / "hyp" / "metadata").write_text(json.dumps(hyp))
        handlers["hyp"] = _HANDLERS["hyp"]
    now = time.time_ns()
    (tmp / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": handlers, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now, "custom_metadata": {}}))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


# ------------------------------------------------- a port YOLOv5 state

_TRUNK = {"focus": "stem", "backbone_stage4_spp": "b4_spp"}
_TRUNK.update({f"backbone_stage{i}_{a}": f"b{i}_{b}" for i in range(1, 5)
               for a, b in (("conv", "conv"), ("bscp", "csp"))})
_TRUNK.update({f"head_stage{i}_{a}": f"h{i}_{b}" for i in range(1, 5)
               for a, b in (("conv", "conv"), ("bscp", "csp"))})
_DETECT = {"detect_small": "detect_0", "detect_mid": "detect_1", "detect_large": "detect_2"}
_BN = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def _jax_path(key: str, ndim: int) -> tuple:
    """A port YOLOv5 (C3 trunk) ``state_dict`` key -> (collection, JAX
    path)."""
    *mods, leaf = key.split(".")
    if mods[0] == "detect":
        return "params", ("detect", _DETECT[mods[1]], "kernel" if leaf == "weight" else leaf)
    path, i = ["trunk", _TRUNK[mods[0]]], 1
    while i < len(mods):
        m = mods[i]
        if m == "blocks":
            path.append(f"block{mods[i + 1]}")
            i += 1
        elif m.startswith("cba") or m.startswith("conv_bn_act_"):
            path.append("cv" + m.rsplit("_", 1)[-1].removeprefix("cba"))
        else:  # conv / bn
            path.append(m)
        i += 1
    if mods[-1] == "bn":
        return ("batch_stats" if leaf.startswith("running") else "params",
                tuple(path) + (_BN[leaf],))
    return "params", tuple(path) + ("kernel" if ndim == 4 else leaf,)


def _to_jax_layout(value: np.ndarray) -> np.ndarray:
    return value.transpose(2, 3, 1, 0) if value.ndim == 4 else value  # OIHW -> HWIO


def yolov5_jax_trees(state_dict: dict) -> tuple:
    """A port YOLOv5 (C3 trunk) ``state_dict`` -> the JAX package's
    (params, batch_stats) trees of numpy arrays."""
    trees = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        value = value.detach().cpu().numpy()
        coll, path = _jax_path(key, value.ndim)
        node = trees[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _to_jax_layout(value)
    return trees["params"], trees["batch_stats"]


def _masked(params: dict, keep: dict) -> dict:
    """``params``' shape with ``keep[path]`` at its leaves, None elsewhere."""
    return {k: _masked(v, keep.get(k, {})) if isinstance(v, dict) else keep.get(k)
            for k, v in params.items()}


def yolov5_train_state_tree(state) -> dict:
    """The JAX ``TrainState`` tree (as ``save_checkpoint`` writes it) of a
    port YOLOv5 train state with the SGD optimizer: params, batch stats,
    EMA, step, EMA count, balances and the optax state, each group's
    ``inject_hyperparams`` state with its count, its current lr and
    momentum, and its Nesterov trace (None at the other groups' leaves)."""
    opt = state.optimizer
    if opt.kind != "sgd":
        raise ValueError("yolov5_train_state_tree writes the SGD optimizer's state")
    params, stats = yolov5_jax_trees(state.model.state_dict())
    ema_params, ema_stats = yolov5_jax_trees(state.ema)
    names = {id(p): n for n, p in state.model.named_parameters()}
    groups = {}
    for g in ("weight", "other", "bias"):
        keep: dict = {}
        for p, t in zip(opt.groups[g], opt.state[g]["trace"]):
            _, path = _jax_path(names[id(p)], p.dim())
            node = keep
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = _to_jax_layout(t.detach().cpu().numpy())
        count = opt.counts[g]
        inject = {
            "count": np.int32(count),
            "hyperparams": {"learning_rate": np.float32(opt.lr_schedules[g](count)),
                            "momentum": np.float32(opt.momentum_schedule(count))},
            "hyperparams_states": {"learning_rate": {"count": np.int32(count)},
                                   "momentum": {"count": np.int32(count)}},
            "inner_state": {"0": {"trace": _masked(params, keep)}, "1": None},
        }
        decays = opt.decay[g] > 0  # add_decayed_weights' empty state first
        groups[g] = {"inner_state": {"0": None, "1": inject} if decays else inject}
    return {
        "step": np.int32(state.step),
        "params": params,
        "batch_stats": stats,
        "opt_state": {"0": None, "1": {"inner_states": groups}},
        "ema_params": ema_params,
        "ema_batch_stats": ema_stats,
        "ema_count": np.float32(state.ema_count),
        "balances": state.balances.detach().cpu().numpy().astype(np.float32),
    }
