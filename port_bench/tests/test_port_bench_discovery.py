"""Every piece of every cell is found by the names in BENCHMARK.json, and
the file keeps to the benchmark's contract."""

import json
import re

import pytest

from port_bench.core import spec

BENCH = spec.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# a width may never be reduced: a hidden, intermediate, latent, state or
# projection size, a ``_dim`` or ``_rank``, a head size, an expansion factor,
# the experts per token; here also a width multiple or a head's width
WIDTH = re.compile(r"_dim$|_rank$|width|hidden|intermediate|latent|state|proj|head|expan"
                   r"|experts_per")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for path in BENCH["paths"]:
        assert (spec.ROOT / path).is_dir()


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert all(m["source"] in ("host_clock", "device_trace") for m in BENCH["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell_name", CELLS)
def test_cell_pieces(cell_name):
    cell = spec.cell(BENCH, cell_name)
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    cfg = spec.config(BENCH, cell["config"])
    assert cfg["name"] == cell["config"]
    t = spec.traffic(cell["traffic"])
    driver = spec.driver(t["kind"])
    assert callable(driver.run)
    assert set(spec.checks(cell_name)) == set(driver.NUMBERS)
    e2e = {m["name"] for m in spec.end_to_end(BENCH, cell_name)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer(BENCH, cell_name)
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in layer:
        assert callable(spec.reader(m["name"]))


def test_four_chip_cells_are_few():
    # at most a quarter of the cells, rounded down, ask for 4 chips; one always may
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4), four


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_reduced_lists_keys_of_the_file(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = spec.config(BENCH, name)
    assert isinstance(entry["reduced"], list) and len(entry["reduced"]) <= 16
    assert entry["reduced"] == cfg["reduced"]
    assert set(entry["reduced"]) <= set(cfg) - {"name", "source", "reduced"}
    assert not [k for k in entry["reduced"] if WIDTH.search(k) or not NAME.match(k)]


def test_metric_workloads_are_cells():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))


def test_reader_by_base_name():
    # a split quantity (``<base>.<part>``) is read by ``metrics/<base>.py``
    assert spec.reader("device_idle_pct.serve") is not None
    assert spec.reader("device_idle_pct.tail").__module__ == "port_bench.metrics.device_idle_pct"
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.part")
