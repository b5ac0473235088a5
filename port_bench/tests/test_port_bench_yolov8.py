"""The ``yolov8`` configuration's plain reference and its readers.

* Golden digests of the reference (``reference/families/yolov8.py``,
  ``reference/yolov8_loss.py``), as ``test_port_bench_families.py`` takes
  them for the other configurations: the seeded weights, the raw maps, the
  detections and greedy's IoU counts, and one update, on the CPU in one
  thread at 64 x 64. ``GOLDEN`` was taken when the reference was written.
* The padded share of the assigner's lattice (``assign_pad_pct``) and the
  assigner's share (``assign_share_pct`` on YOLOv8's range) on recorded
  registry snapshots and summaries; None where their input is missing.
"""

import pytest
import torch

from port_bench.core import registry, spec
from port_bench.core.trace import Summary
from port_bench.tests.test_port_bench_families import PARTS, _config, _digest, readings

GOLDEN = {
    "state": "1cb3b4eba9540d2b70bf683b0e2757681f24e64b7edf5919dab9611efd08cb8b",
    "maps": "daa7f3a1de6624aea2a05b0ef66a4249a9634e0b8f18a27bb9ef7328de72a7f8",
    "detect": "0240f13f2a241f2843d232fc67f8bc4eeaa9028c9b3223de07bd9dcbcb2b9739",
    "update": "9f2e771ba4d2035a3bc288b3432ef9ad708f4496dbe5ac9b585a5eda9804df79",
}


@pytest.mark.parametrize("part", PARTS)
def test_reference_readings(part):
    torch.set_num_threads(1)
    assert _digest(readings(_config("yolov8"), part)) == GOLDEN[part]


def _snap(counters):
    return {"spans": [], "counters": counters}


def test_assign_pad_share(monkeypatch):
    read = spec.reader("assign_pad_pct.yolov8")
    # 128 images x 300 slots, 6.5 boxes an image
    monkeypatch.setattr(registry, "totals", lambda: _snap({"train.gt_slots": 38_400,
                                                           "train.gt_boxes": 832}))
    assert read({}) == pytest.approx(100.0 * (1 - 6.5 / 300))
    for snap in (None, _snap({}), _snap({"train.gt_slots": 38_400})):
        monkeypatch.setattr(registry, "totals", lambda snap=snap: snap)
        assert read({}) is None


def test_assign_share_on_yolov8s_range():
    read = spec.reader("assign_share_pct.yolov8")
    s = Summary(window_us=200.0, busy_us=100.0, launches=4, kernels=4,
                ranges={"yolov8_loss.assign": 30.0, "yolov8_loss.terms": 5.0})
    assert read({"summary": s, "cfg": {"family": "yolov8"}}) == pytest.approx(30.0)
    assert read({"summary": None, "cfg": {"family": "yolov8"}}) is None
