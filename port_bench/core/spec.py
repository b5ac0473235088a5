"""Find every piece of a cell by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration (``configs``
entry, whose ``file`` holds its sizes) and a traffic mix
(``traffic/<mix>.json``, whose ``kind`` names the driver
``drivers/<kind>.py``). Per-layer metrics are read by
``metrics/<metric name>.py``, or by the file of the name before its first
dot (a function ``read(ctx)``), and the limits of
the cell's output check are in ``checks/<cell name>.json``. The plain
reference finds a configuration's detector family, by the file's
``family`` key, in ``reference/families/<family>.py``. Adding a cell, a
mix, a driver or a metric adds files and entries and edits none; so does
adding a configuration, of a benchmarked family or of a new one: a family
module (with its loss under ``reference/``, where the family has a new
one), a config file, a traffic file, a checks file, and the entries in
``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((PKG / "traffic" / f"{name}.json").read_text())


def driver(kind: str):
    return importlib.import_module(f"port_bench.drivers.{kind}")


def checks(cell_name: str) -> dict:
    """{number: limit} of the cell's output check; {} where none is set."""
    path = PKG / "checks" / f"{cell_name}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else {}


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def reader(metric: str):
    """The ``read(ctx) -> float | None`` of ``metrics/<metric>.py``, or else
    of ``metrics/<base>.py``, the base being the name before its first dot:
    ``device_idle_pct.serve`` and ``device_idle_pct.train`` are one
    quantity split by the end-to-end metric it moves, read alike."""
    path = PKG / "metrics" / f"{metric}.py"
    if not path.exists():
        path = PKG / "metrics" / f"{metric.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
