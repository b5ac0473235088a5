"""The result line's schema and the import-name check."""

import json

import pytest

from port_bench import run
from port_bench.core import hygiene, spec
from port_bench.tests._tiny import cells, tiny_run


@pytest.mark.parametrize("cell_name", cells())
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(cell_name, trace):
    bench = spec.load_bench()
    out = tiny_run(cell_name)
    if trace:  # a CPU run has no device trace: its readers find nothing to read
        out["ctx"]["summary"] = None
    line = run.result_line(out, cell_name, bench, trace,
                           {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    wanted = spec.per_layer(bench, cell_name) if trace else spec.end_to_end(bench, cell_name)
    names = {m["name"] for m in wanted}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(line)


def test_forbidden_modules_by_whole_name():
    assert hygiene.forbidden_modules({"yoloseries_tpu_torch": 1, "yoloseries_tpu_torch.ops": 1,
                                      "jaxtyping": 1, "numpy": 1}) == []
    assert hygiene.forbidden_modules({"yoloseries_tpu.ops": 1, "jaxlib.xla": 1, "flax": 1}) == [
        "flax", "jaxlib", "yoloseries_tpu"]


def test_this_process_is_clean():
    tiny_run(cells()[0])
    assert hygiene.forbidden_modules() == []
