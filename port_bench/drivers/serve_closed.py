"""Closed-loop batch serving through the port's ``Evaluator``.

One client sends uint8 host batches (B, H, W, 3) and waits for each batch's
detections on the host before it sends the next: the call is
``Evaluator.__call__`` built as ``cli/detect.py`` builds it (the family's
decode, fused selection and eval overrides), then ``.cpu()``. The batches
cycle through a pool of distinct batches drawn from the seed.

Traffic keys (``traffic/<mix>.json``): ``batch``, ``image_size``, ``pool``,
the ``EvalConfig`` fields ``conf_threshold``, ``cls_threshold``,
``iou_threshold``, ``num_candidates``, ``max_keep``, ``class_aware``,
``merge_boxes``; ``warmup_calls`` (set-up), ``trace_calls`` (the profiled
window of a ``--trace 1`` run) and ``ref_block`` (images per reference
forward).

Output check: once the window has closed and the program is freed, the
plain reference (``reference/``) works out the detections of every pool
batch that was served, and every call's detections are held against them
(``reference/compare.py``).
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from ..core import weights
from ..reference import compare, detect, models

NUMBERS = ("unmatched_pct", "conf_gap", "box_gap_px")
EVAL_KEYS = ("conf_threshold", "cls_threshold", "iou_threshold", "num_candidates", "max_keep",
             "class_aware", "merge_boxes")


def build_program(cfg, t, sd, device):
    """The port's evaluator over the port's model holding ``sd``."""
    from yoloseries_tpu_torch.evaluation import EvalConfig, Evaluator
    from yoloseries_tpu_torch.families import get_family
    from yoloseries_tpu_torch.models import create_model

    size = (t["image_size"], t["image_size"])
    model = create_model(cfg["program_model"], num_class=cfg["nc"], device=device, seed=0)
    model.load_state_dict(sd, strict=True)
    family = get_family(cfg["program_model"])
    ecfg = family.apply_eval_overrides(EvalConfig(**{k: t[k] for k in EVAL_KEYS}))
    select = family.make_select({}, cfg["nc"], size) if family.make_select else None
    return Evaluator(model, family.make_decode({}, cfg["nc"], size), ecfg,
                     select(ecfg) if select else None, device=device)


def make_pool(seed, t, device):
    """``pool`` distinct host batches (B, H, W, 3) uint8, drawn on the device."""
    shape = (t["batch"], t["image_size"], t["image_size"], 3)
    return [weights.images_u8(seed, 2 + j, shape, device).cpu().numpy() for j in range(t["pool"])]


@torch.no_grad()
def reference(sd, cfg, t, batch_u8, device, tf32=False):
    """The reference's detections of one host batch, in blocks of
    ``ref_block`` images, in f32 (TF32 only for the control). Returns
    (detections (B, max_keep, 6) on ``device``, greedy's IoUs summed)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.benchmark = False
    try:
        x = torch.from_numpy(batch_u8).to(device)
        dets, ious = [], 0
        for s in range(0, len(x), t["ref_block"]):
            d, n = detect.detect(models.forward(sd, weights.to_input(x[s:s + t["ref_block"]]),
                                                cfg), cfg, t)
            dets.append(d)
            ious += int(n.sum())
        return torch.cat(dets), ious
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = flags


def run(cell, cfg, t, seed, seconds, trace, device, t0, log, limits):
    from yoloseries_tpu_torch.device import set_numeric_mode

    from ..core.trace import profile_calls

    set_numeric_mode()
    dev = torch.device(device)
    marks = [("start", time.perf_counter())]
    sd = weights.seeded_state(cfg, seed, dev, t["image_size"])
    marks.append(("weights", time.perf_counter()))
    ev = build_program(cfg, t, sd, dev)
    marks.append(("program", time.perf_counter()))
    pool = make_pool(seed, t, dev)
    marks.append(("pool", time.perf_counter()))
    b = t["batch"]
    calls = []  # (pool index, host detections) of every call
    lat = []

    def call():
        j = len(calls) % len(pool)
        t1 = time.perf_counter()
        dets = ev(pool[j]).cpu()
        lat.append(time.perf_counter() - t1)
        calls.append((j, dets))
        return j

    for i in range(t["warmup_calls"]):
        ev(pool[i % len(pool)]).cpu()
    calls.clear()
    lat.clear()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    gc.collect()
    gc.freeze()  # set-up's objects are not scanned again in the window
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    setup_s = start - t0
    marks.append(("warm-up", start))
    log("setup: imports " + f"{marks[0][1] - t0:.3f} s, " + ", ".join(
        f"{name} {t2 - t1:.3f} s" for (_, t1), (name, t2) in zip(marks, marks[1:])))
    while True:
        call()
        if time.perf_counter() - start >= seconds:
            break
    window_s = time.perf_counter() - start
    n_main = len(calls)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    lat_ms = sorted(x * 1e3 for x in lat)
    q = statistics.quantiles(lat_ms, n=20) if len(lat_ms) > 1 else lat_ms * 19
    log(f"window: {n_main} calls of B={b} in {window_s:.3f} s; latency median "
        f"{statistics.median(lat_ms):.3f} ms, p95 {q[18]:.3f} ms, max {lat_ms[-1]:.3f} ms "
        f"over {len(lat_ms)} samples; setup {setup_s:.3f} s; peak {peak} bytes")
    summary, traced = None, []
    if trace:
        summary, traced = profile_calls(call, t["trace_calls"], log)
    ev = None  # the program's state is freed before the reference runs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    tally = compare.Tally()
    ious = {}
    for j in sorted({j for j, _ in calls}):
        want, ious[j] = reference(sd, cfg, t, pool[j], dev)
        for jj, got in calls:
            if jj == j:
                tally.add(got.to(dev), want)
    numbers = tally.numbers()
    checks = [(name, numbers[name], limits.get(name)) for name in NUMBERS]
    correct = numbers["ref_detections"] > 0 and all(
        lim is not None and np.isfinite(v) and v <= lim for _, v, lim in checks)
    log(f"check: {len(calls)} calls against the reference, {numbers['ref_detections']} "
        f"reference detections, {time.perf_counter() - t_ref:.3f} s")
    e2e = {"serve_img_per_s": (n_main * b / window_s, "img/s"),
           "serve_p95_ms": (q[18], "ms"),
           "peak_mem_gib": (peak / 2**30, "GiB"),
           "setup_s": (setup_s, "s")}
    ctx = {"cfg": cfg, "traffic": t, "img_per_s": n_main * b / window_s,
           "p50_ms": statistics.median(lat_ms),
           "summary": summary, "traced": traced, "nms_ious": ious}
    return {"e2e": e2e, "ctx": ctx, "checks": checks, "correct": correct,
            "attempted": len(calls) * b, "failed": 0, "peak_bytes": peak}
