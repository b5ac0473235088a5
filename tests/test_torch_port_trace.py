"""The port's tracing registry (``yoloseries_tpu_torch/utils/trace.py``)
and the spans and counters the port records through it, on the CPU.

* the registry: totals, counts, the enclosing span and self time under
  nesting, threads apart, snapshots and resets;
* under ``torch.profiler`` every span is a range of its name, and the
  registry's profiled host time agrees with the range's;
* ``Evaluator.__call__``: its four phase spans, the first call at a shape
  inside ``warmup.eval`` and the next outside it, and the same detections
  as with every span a no-op;
* the loader's counters: a process-worker ``DataLoader`` in a fresh
  interpreter (no JAX to fork) counts its samples, their workers' time and
  its batches;
* a ``Trainer`` update with the render on the device and SimOTA still shows
  ``train.render`` and ``yolox_loss.assign`` under the profiler;
* the NMS wrappers' launches are registry counters.
"""

import json
import os
import subprocess
import sys
import threading
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from yoloseries_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def clean_registry():
    trace.reset()
    yield
    trace.reset()


def _spans():
    """{(name, parent, profiled): record} of the registry's totals."""
    return {(s["name"], s["parent"], s["profiled"]): s for s in trace.totals()["spans"]}


def _busy(seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


# ------------------------------------------------------------ the registry

def test_nested_spans_keep_parent_calls_and_self_time():
    for _ in range(3):
        with trace.span("outer"):
            _busy(0.002)
            with trace.span("inner"):
                _busy(0.003)
            with trace.span("inner"):
                _busy(0.001)
    with trace.span("inner"):  # the same name at the top: a total of its own
        pass
    spans = _spans()
    assert set(spans) == {("outer", None, False), ("inner", "outer", False),
                          ("inner", None, False)}
    outer, inner = spans["outer", None, False], spans["inner", "outer", False]
    assert (outer["calls"], inner["calls"], spans["inner", None, False]["calls"]) == (3, 6, 1)
    assert inner["ns"] >= 3 * 0.004e9 and inner["self_ns"] == inner["ns"]
    assert outer["ns"] >= inner["ns"] + 3 * 0.002e9
    assert outer["self_ns"] == outer["ns"] - inner["ns"]
    assert 3 * 0.002e9 <= outer["self_ns"] < outer["ns"]


def test_counters_add_and_reset_clears_both():
    trace.count("a")
    trace.count("a", 4)
    trace.count("b", -2)
    with trace.span("s"):
        pass
    snap = trace.totals()
    assert snap["counters"] == {"a": 5, "b": -2}
    trace.count("a")  # a snapshot is a copy
    assert snap["counters"]["a"] == 5 and trace.totals()["counters"]["a"] == 6
    trace.reset()
    assert trace.totals() == {"spans": [], "counters": {}}


def test_spans_of_threads_nest_apart_and_add_up():
    def work():
        for _ in range(200):
            with trace.span("t.outer"):
                with trace.span("t.inner"):
                    trace.count("t.n")

    threads = [threading.Thread(target=work) for _ in range(4)]
    with trace.span("main"):
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans = _spans()
    assert spans["t.outer", None, False]["calls"] == 800  # not inside "main"
    assert spans["t.inner", "t.outer", False]["calls"] == 800
    assert spans["main", None, False]["self_ns"] == spans["main", None, False]["ns"]
    assert trace.totals()["counters"]["t.n"] == 800


def test_warmup_spans_only_the_first_call_of_a_key():
    seen = set()
    for key in ("a", "a", "b", "a"):
        with trace.warmup("warmup.x", seen, key):
            with trace.span("x"):
                pass
    spans = _spans()
    assert spans["warmup.x", None, False]["calls"] == 2
    assert spans["x", "warmup.x", False]["calls"] == 2
    assert spans["x", None, False]["calls"] == 2
    assert trace.totals()["counters"] == {"warmup.shapes": 2}


def test_profiled_spans_are_ranges_with_the_same_duration():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span("p.outer"):
                _busy(0.002)
                with trace.span("p.inner"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
                    _busy(0.001)
    with trace.span("p.outer"):  # after the profiler: unprofiled
        pass
    ranges = {}
    for e in prof.events():
        if e.name.startswith("p."):
            ranges.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    spans = _spans()
    assert spans["p.outer", None, False]["calls"] == 1
    for name, parent in (("p.outer", None), ("p.inner", "p.outer")):
        got = spans[name, parent, True]
        assert len(ranges[name]) == got["calls"] == 3
        range_us, span_us = sum(ranges[name]), got["ns"] / 1e3
        assert abs(span_us - range_us) <= max(0.1 * range_us, 50.0), (name, span_us, range_us)


# ------------------------------------------------------------ the evaluator

def _evaluator():
    from yoloseries_tpu_torch.evaluation import EvalConfig, Evaluator
    from yoloseries_tpu_torch.families import get_family
    from yoloseries_tpu_torch.models import create_model

    family, size = get_family("yolox_s"), (64, 64)
    ecfg = family.apply_eval_overrides(EvalConfig(conf_threshold=0.01, cls_threshold=0.01,
                                                  num_candidates=64, max_keep=20))
    select = family.make_select({}, 3, size)
    return Evaluator(create_model("yolox_s", num_class=3, device="cpu", seed=0),
                     family.make_decode({}, 3, size), ecfg, select(ecfg), device="cpu")


PHASES = ("eval.prepare", "eval.forward", "eval.select", "eval.nms")


def test_evaluator_records_its_phases_and_warms_up_once(monkeypatch):
    from yoloseries_tpu_torch.evaluation import yolov5

    img = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    ev = _evaluator()
    first = ev(img)
    spans = _spans()
    assert spans["warmup.eval", None, False]["calls"] == 1
    assert all(spans[p, "warmup.eval", False]["calls"] == 1 for p in PHASES)
    assert trace.totals()["counters"] == {"warmup.shapes": 1}

    trace.reset()
    second = ev(img)  # the same shape: no warm-up
    spans = _spans()
    assert set(spans) == {(p, None, False) for p in PHASES}
    assert all(spans[p, None, False]["calls"] == 1 for p in PHASES)
    assert trace.totals()["counters"] == {}

    monkeypatch.setattr(yolov5, "span", lambda name: nullcontext())
    monkeypatch.setattr(yolov5, "warmup", lambda name, seen, key: nullcontext())
    trace.reset()
    plain = _evaluator()(img)
    assert trace.totals()["spans"] == []
    assert torch.equal(first, plain) and torch.equal(second, plain)


def test_evaluator_phases_are_ranges_under_the_profiler():
    img = np.random.default_rng(1).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    ev = _evaluator()
    ev(img)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ev(img)
    names = [e.name for e in prof.events()]
    assert all(names.count(p) == 1 for p in PHASES)
    assert "warmup.eval" not in names
    assert all(_spans()[p, None, True]["calls"] == 1 for p in PHASES)


# ------------------------------------------------------------ the loader

LOADER_CHECK = r"""
import json, sys
from yoloseries_tpu_torch.data import DataLoader, DetectionDataset
from yoloseries_tpu_torch.data.augment import AugmentConfig
from yoloseries_tpu_torch.utils import trace

img_dir, lab_dir, names, cache_dir = sys.argv[1:5]
out = {}
for path, aug in (("letterbox", False), ("augment", True)):
    ds = DetectionDataset(img_dir, lab_dir, names, input_size=(64, 64),
                          aug=AugmentConfig(input_size=(64, 64)), enable_aug=aug,
                          cache_images=True, cache_dir=cache_dir + path)
    trace.reset()
    loader = DataLoader(ds, batch_size=4, max_labels=12, seed=4, workers=2,
                        use_processes=True)
    assert loader._proc_pool is not None
    try:
        for _ in range(3):
            next(loader)
    finally:
        loader.stop()
    out[path] = trace.totals()
jax = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
print(json.dumps({"jax": jax, "totals": out}))
"""


def test_process_loader_counts_its_samples(tmp_path):
    img_dir, lab_dir = tmp_path / "img", tmp_path / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    rng = np.random.default_rng(3)
    for i in range(6):
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            img_dir / f"{i}.png")
        (lab_dir / f"{i}.txt").write_text(f"{i % 3} 4 5 {w // 2} {h // 2}\n")
    names = tmp_path / "names.txt"
    names.write_text("0 a\n1 b\n2 c\n")
    proc = subprocess.run(
        [sys.executable, "-c", LOADER_CHECK, str(img_dir), str(lab_dir), str(names),
         str(tmp_path / "cache_")], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = json.loads(proc.stdout.splitlines()[-1])
    assert not got["jax"]
    for path, totals in got["totals"].items():
        counters = totals["counters"]
        batches = counters["loader.batches"]
        assert batches >= 3  # the 3 consumed, and what the producer made ahead
        assert counters["loader.workers"] == 2
        assert counters[f"loader.samples.{path}"] == batches * 4
        assert counters[f"loader.sample_ns.{path}"] > 0 and counters["loader.batch_ns"] > 0
        assert not any(k.startswith("loader.samples.") and k != f"loader.samples.{path}"
                       for k in counters)
        waits = [s for s in totals["spans"] if s["name"] == "loader.wait"]
        assert [(s["parent"], s["profiled"], s["calls"]) for s in waits] == [(None, False, 3)]


# ------------------------------------------------------------ training

def test_trainer_update_keeps_its_range_names_under_the_profiler(tmp_path):
    """The YOLOX preset at 64 px, B=2, the augmentation planned on the host
    and rendered from the image cache on the device (here the CPU)."""
    from yoloseries_tpu_torch.configs import TrainConfig
    from yoloseries_tpu_torch.configs.config import load_hyp
    from yoloseries_tpu_torch.train import Trainer

    img_dir, lab_dir = tmp_path / "img", tmp_path / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (48 + 8 * i, 64, 3), dtype=np.uint8)).save(
            img_dir / f"{i}.png")
        (lab_dir / f"{i}.txt").write_text("0 4 4 30 30\n1 10 12 40 40\n")
    names = tmp_path / "names.txt"
    names.write_text("0 a\n1 b\n")
    hyp = load_hyp(ROOT / "yoloseries_tpu_torch/configs/presets/train_yolox.yaml")
    hyp.update(input_img_size=[64, 64], batch_size=2, accumulate_loss_step=2, num_workers=1,
               device_aug=True, device_cache=True, cache_images=True, total_epoch=1,
               save_log_txt=False, enable_tensorboard=False)
    cfg = TrainConfig.from_hyp(hyp, num_class=2, model="yolox_s", max_labels=8,
                               output_dir=str(tmp_path / "out"))
    trainer = Trainer(cfg, (img_dir, lab_dir), names_path=names, log_fn=lambda *a: None,
                      device="cpu")
    try:
        assert trainer.train_loader.device_aug and trainer._dev_cache is not None
        step = trainer._step_fn_for(tuple(cfg.input_size))
        setup = {s["name"] for s in trace.totals()["spans"]}
        assert {"setup.data", "setup.model", "setup.loader"} <= setup

        def update():
            batch = trainer._device_batch(next(trainer.train_loader))
            trainer.state, _ = step(trainer.state, batch)

        update()
        warm = _spans()
        assert warm["warmup.train_step", None, False]["calls"] == 1
        assert warm["warmup.device_batch", None, False]["calls"] == 1
        assert warm["train.render", "warmup.device_batch", False]["calls"] == 1
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            update()
    finally:
        trainer.close()
    names_seen = {e.name for e in prof.events()}
    assert {"train.h2d", "train.render", "train.forward", "train.loss", "train.backward",
            "train.optimizer", "train.ema", "yolox_loss.assign", "loader.wait"} <= names_seen
    assert not any(n.startswith("warmup.") for n in names_seen)
    spans = _spans()
    assert spans["train.render", None, True]["calls"] == 1
    assert spans["yolox_loss.assign", "train.loss", True]["calls"] >= 1
    assert trace.totals()["counters"]["warmup.shapes"] == 2


# ------------------------------------------------------------ the NMS counters

def test_nms_wrappers_have_no_launch_attribute():
    from yoloseries_tpu_torch.kernels import nms_greedy, nms_matrix

    for fn in (nms_greedy.nms_greedy, nms_matrix.nms_relation, nms_matrix.matrix_nms,
               nms_matrix.matrix_nms_chunked):
        assert not hasattr(fn, "launches")


def test_a_launch_is_counted_in_the_registry(monkeypatch):
    """``launch_nms`` counts under the wrapper's counter once its C call
    returned (the C call stubbed: this CPU has no card)."""
    from yoloseries_tpu_torch.kernels import _build, nms_greedy

    calls = []
    monkeypatch.setattr(_build, "launch", lambda entry, dev, *args: calls.append(entry))
    monkeypatch.setattr(nms_greedy, "check_cuda_inputs", lambda *a: None)
    boxes, scores = torch.zeros(2, 8, 4), torch.ones(2, 8)
    nms_greedy.launch_nms("yst_nms_greedy", "nms_greedy.launches", boxes, scores, 0.5, 4)
    nms_greedy.launch_nms("yst_nms_greedy", "nms_greedy.launches", boxes, scores, 0.5, 4)
    assert calls == ["yst_nms_greedy"] * 2
    assert trace.totals()["counters"] == {"nms_greedy.launches": 2}
