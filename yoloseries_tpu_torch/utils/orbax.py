"""One Orbax checkpoint step, as the JAX package's ``save_checkpoint``
writes it, read with the standard library and numpy only (no orbax,
tensorstore or zstandard).

Layout of a step directory: ``_CHECKPOINT_METADATA`` (JSON; it is written
last, so a step without it was never committed, and an unfinished save sits
in a ``*.orbax-checkpoint-tmp-*`` directory), one directory per item: the
``hyp`` item as ``hyp/metadata`` (JSON), the ``state`` item as
``state/_METADATA`` (the tree: one entry per leaf keyed by its path, with
its value type; masked optimizer leaves and empty states have value type
``"None"``) beside the arrays. Each array is a zarr v2 array named by its
path joined with ``.``: ``<name>/.zarray`` and its chunks
``<name>/<i>.<j>...``, zstd-compressed, kept in an OCDBT store
(``utils/ocdbt.py``; ``use_ocdbt: true``, the default) or as plain files
(``use_ocdbt: false``).

    for step in steps("runs/checkpoints"): ...
    tree = read_tree(step_dir, keys=("ema_params", "ema_batch_stats"))
    tree["ema_params"]["trunk"]["stem"]["conv"]["kernel"]  # numpy array

A zarr3 layout (``use_zarr3: true``) and items of other handlers raise a
``ValueError`` that names the flag or the handler.
"""

from __future__ import annotations

import ast
import json
import math
from itertools import product
from pathlib import Path

import numpy as np

from .ocdbt import OcdbtStore
from .zstd import decompress

__all__ = ["steps", "is_orbax_step", "read_json_item", "read_tree"]

_TMP = ".orbax-checkpoint-tmp"
_TREE_HANDLERS = ("StandardCheckpointHandler", "PyTreeCheckpointHandler")
_JSON_HANDLERS = ("JsonCheckpointHandler",)
_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
_EMPTY_TYPES = ("Dict", "List", "Tuple")  # an empty container: no leaves under it
# every chunk was written, those equal to the fill value too: one missing is an error
_ALL_CHUNKS = "store_array_data_equal_to_fill_value"


def is_orbax_step(path: Path) -> bool:
    """A committed Orbax step: named by its number, holding
    ``_CHECKPOINT_METADATA``."""
    return path.name.isdigit() and (path / "_CHECKPOINT_METADATA").is_file()


def steps(ckpt_dir) -> list:
    """The committed steps under ``ckpt_dir``, ascending (unfinished
    ``*.orbax-checkpoint-tmp-*`` saves are not steps)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []
    return sorted(int(p.name) for p in ckpt_dir.iterdir() if _TMP not in p.name
                  and is_orbax_step(p))


def _handler(step_dir: Path, item: str, allowed) -> None:
    meta = json.loads((step_dir / "_CHECKPOINT_METADATA").read_text())
    handlers = meta.get("item_handlers") or {}
    if item not in handlers and not (step_dir / item).is_dir():
        raise KeyError(f"{step_dir}: no item {item!r}")
    name = handlers.get(item)
    if name is not None and name.rsplit(".", 1)[-1] not in allowed:
        raise ValueError(f"{step_dir}: item {item!r} has handler {name}, which this reader "
                         f"does not know (it reads {', '.join(allowed)})")


def read_json_item(step_dir, name: str = "hyp"):
    """A ``JsonSave`` item (the hyp) of a step."""
    step_dir = Path(step_dir)
    _handler(step_dir, name, _JSON_HANDLERS)
    return json.loads((step_dir / name / "metadata").read_text())


class _DirStore:
    """The plain-file layout (``use_ocdbt: false``): a key is a path."""

    def __init__(self, root: Path):
        self.root = root
        self.bytes_read = 0

    def __contains__(self, key: str) -> bool:
        return (self.root / key).is_file()

    def get(self, key: str) -> bytes:
        data = (self.root / key).read_bytes()
        self.bytes_read += len(data)
        return data


def _open_item(step_dir, item: str):
    """(tree metadata, key-value store, whether every chunk was stored) of a
    tree item."""
    step_dir = Path(step_dir)
    _handler(step_dir, item, _TREE_HANDLERS)
    root = step_dir / item
    meta = json.loads((root / "_METADATA").read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{root}: use_zarr3: true (zarr v3 arrays) is not supported; "
                         "only zarr v2 (use_zarr3: false) is read")
    use_ocdbt = meta.get("use_ocdbt", (root / "manifest.ocdbt").is_file())
    store = OcdbtStore(root) if use_ocdbt else _DirStore(root)
    return meta["tree_metadata"], store, bool(meta.get(_ALL_CHUNKS))


def _dtype(spec):
    if spec == "bfloat16":
        return np.dtype("<u2"), True
    if not isinstance(spec, str):
        raise ValueError(f"structured zarr dtype {spec!r} is not supported")
    return np.dtype(spec), False


def _fill(value):
    if value is None:
        return 0
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        return float(value.replace("Infinity", "inf"))
    return value


def _read_array(store, name: str, all_chunks: bool) -> np.ndarray:
    """One zarr v2 array: every chunk of its grid decoded and placed. A
    chunk not stored holds the fill value, unless ``all_chunks`` (the
    item's ``store_array_data_equal_to_fill_value``) says every chunk was
    written: then it raises, as orbax does. bfloat16 is widened to float32
    (exactly)."""
    meta = json.loads(store.get(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp.get('id')!r} is not supported")
    dtype, bf16 = _dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value")), dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for idx in (product(*map(range, grid)) if shape else [()]):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            if all_chunks:
                raise ValueError(f"chunk {key} is missing, and {_ALL_CHUNKS} is true")
            continue
        raw = store.get(key)
        if comp is not None:
            raw = decompress(raw)
        chunk = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        dst = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]
    if bf16:
        out = (out.astype(np.uint32) << 16).view(np.float32)
    return out


def _wanted(path: tuple, keys) -> bool:
    return keys is None or any(path[:len(k)] == k for k in keys)


def read_tree(step_dir, item: str = "state", keys=None, stats: dict | None = None) -> dict:
    """The tree of a step's ``item`` as nested dicts of numpy arrays
    (sequence indices become ``"0"``, ``"1"``, ...; ``None`` where the value
    type is ``"None"``; ``{}`` for an empty dict, list or tuple). ``keys``:
    read only the leaves under these paths (a top-level name, or a path
    joined with ``/``). ``stats``, when given, receives ``bytes_read``."""
    tree_meta, store, all_chunks = _open_item(step_dir, item)
    if keys is not None:
        keys = [tuple(k.split("/")) if isinstance(k, str) else tuple(k) for k in keys]
    tree: dict = {}
    for key_str, entry in tree_meta.items():
        path = (tuple(str(k["key"]) for k in entry["key_metadata"]) if "key_metadata" in entry
                else tuple(map(str, ast.literal_eval(key_str))))
        if not _wanted(path, keys):
            continue
        vm = entry["value_metadata"]
        vtype = vm["value_type"]
        if vtype in _EMPTY_TYPES:
            value = {}
        elif vtype == "None" or vm.get("skip_deserialize"):
            value = None
        elif vtype in _ARRAY_TYPES:
            value = _read_array(store, ".".join(path), all_chunks)
            if vtype == "scalar":
                value = value.item()
        else:
            raise ValueError(f"{step_dir}: leaf {'/'.join(path)} has value type {vtype!r}, "
                             "which this reader does not know")
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    if stats is not None:
        stats["bytes_read"] = store.bytes_read
    return tree
