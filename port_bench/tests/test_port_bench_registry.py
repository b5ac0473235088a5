"""The per-layer metrics read from the program's tracing registry
(``core/registry.py``) and the post-processing share of the device trace,
on fixed registry snapshots, on the registry itself and on a fake
``Summary``: each reads its number, and None where its input is missing."""

import sys

import pytest

from port_bench.core import registry, spec
from port_bench.core.trace import Summary


def _span(name, parent=None, profiled=False, calls=1, ns=0):
    return {"name": name, "parent": parent, "profiled": profiled, "calls": calls, "ns": ns,
            "self_ns": ns}


SNAP = {
    "spans": [
        _span("eval.prepare", "warmup.eval", ns=90_000_000),  # the first call: left out
        _span("eval.prepare", calls=4, ns=8_000_000),
        _span("eval.prepare", profiled=True, calls=2, ns=40_000_000),  # profiled: left out
        _span("train.h2d", "warmup.device_batch", ns=50_000_000),
        _span("train.h2d", calls=10, ns=30_000_000),
        _span("warmup.eval", ns=2_000_000_000),
        _span("warmup.train_step", ns=3_500_000_000),
        _span("warmup.device_batch", ns=500_000_000),
        _span("setup.kernels", "warmup.eval", ns=1_000_000_000),
    ],
    "counters": {"loader.samples.letterbox": 1000, "loader.sample_ns.letterbox": 25_000_000_000,
                 "loader.samples.augment": 384, "loader.sample_ns.augment": 1,
                 "loader.samples.plan": 500, "loader.sample_ns.plan": 1_000_000_000,
                 "loader.workers": 8, "loader.batches": 12, "loader.batch_ns": 240_000_000},
}
EMPTY = {"spans": [], "counters": {}}
CLOSED = {"augmentation": "closed", "hyp": {"accumulate_loss_step": 128}}
DEVICE = {"augmentation": "device", "hyp": {"accumulate_loss_step": 128}}


@pytest.fixture
def snap(monkeypatch):
    """Make the readers see ``value`` as the registry's snapshot."""
    def use(value):
        monkeypatch.setattr(registry, "totals", lambda: value)
    return use


def test_registry_readers_on_a_snapshot(snap):
    snap(SNAP)
    assert spec.reader("prepare_ms.serve")({}) == pytest.approx(2.0)
    assert spec.reader("prepare_ms.tail")({}) == pytest.approx(2.0)
    assert spec.reader("h2d_host_ms.train")({}) == pytest.approx(3.0)
    assert spec.reader("producer_ms.train")({}) == pytest.approx(20.0)
    assert spec.reader("warmup_s")({}) == pytest.approx(6.0)  # setup.kernels is inside
    # 25 ms a letterbox sample x 128 images / (8 workers x 640 ms an update)
    busy = spec.reader("loader_busy_pct.train")
    assert busy({"traffic": CLOSED, "img_per_s": 200.0}) == pytest.approx(62.5)
    # 2 ms a plan x 128 / (8 x 500 ms)
    assert busy({"traffic": DEVICE, "img_per_s": 256.0}) == pytest.approx(6.4)


@pytest.mark.parametrize("value", [None, EMPTY], ids=["no registry", "nothing recorded"])
def test_registry_readers_without_input(snap, value):
    snap(value)
    for name in ("prepare_ms.serve", "h2d_host_ms.train", "producer_ms.train", "warmup_s"):
        assert spec.reader(name)({}) is None, name
    assert spec.reader("loader_busy_pct.train")({"traffic": CLOSED, "img_per_s": 1.0}) is None


def test_loader_busy_needs_its_path_and_a_rate(snap):
    snap({"spans": [], "counters": {"loader.samples.plan": 5, "loader.sample_ns.plan": 5,
                                    "loader.workers": 8}})
    busy = spec.reader("loader_busy_pct.train")
    assert busy({"traffic": CLOSED, "img_per_s": 200.0}) is None  # no letterbox samples
    assert busy({"traffic": DEVICE, "img_per_s": 0.0}) is None
    assert busy({"traffic": DEVICE, "img_per_s": 200.0}) > 0


def test_registry_readers_on_the_program_registry():
    from yoloseries_tpu_torch.utils import trace

    trace.reset()
    try:
        seen = set()
        for _ in range(3):
            with trace.warmup("warmup.eval", seen, "shape"):
                with trace.span("eval.prepare"):
                    pass
        trace.count("loader.batches", 2)
        trace.count("loader.batch_ns", 4_000_000)
        snap = registry.totals()
        assert registry.span_ms(snap, "eval.prepare") is not None  # the 2 calls after the first
        assert [s["calls"] for s in snap["spans"] if s["name"] == "eval.prepare"
                and s["parent"] is None] == [2]
        assert registry.warmup_s(snap) > 0
        assert spec.reader("producer_ms.train")({}) == pytest.approx(2.0)
    finally:
        trace.reset()


def test_no_registry_in_the_program(monkeypatch):
    """A program without ``utils/trace.py`` (an older commit): None."""
    monkeypatch.setitem(sys.modules, "yoloseries_tpu_torch.utils.trace", None)
    assert registry.totals() is None
    assert spec.reader("warmup_s")({}) is None


def _summary(ranges, busy=100.0):
    return Summary(window_us=200.0, busy_us=busy, launches=4, kernels=4, ranges=ranges)


def test_postprocess_share():
    read = spec.reader("postprocess_share_pct.serve")
    assert spec.reader("postprocess_share_pct.tail") is not None
    s = _summary({"eval.forward": 60.0, "eval.select": 5.0, "eval.nms": 15.0})
    assert read({"summary": s}) == pytest.approx(20.0)
    assert read({"summary": _summary({"eval.nms": 15.0})}) == pytest.approx(15.0)
    assert read({"summary": _summary({"eval.forward": 60.0})}) is None  # no such ranges
    assert read({"summary": None}) is None
    partial = Summary(window_us=200.0, busy_us=100.0, launches=4, kernels=3,
                      ranges={"eval.nms": 15.0})
    assert read({"summary": partial}) is None  # coverage short of whole


def test_assign_share_by_family():
    # the range of the configuration's family, and no other family's
    read = spec.reader("assign_share_pct.yolox")
    s = _summary({"yolox_loss.assign": 17.0, "yolov8_loss.assign": 30.0})
    assert read({"summary": s, "cfg": {"family": "yolox"}}) == pytest.approx(17.0)
    assert read({"summary": s, "cfg": {"family": "yolov8"}}) == pytest.approx(30.0)
    assert read({"summary": s, "cfg": {"family": "yolov5"}}) is None
    assert read({"summary": None, "cfg": {"family": "yolox"}}) is None
