"""A cell's run at a tiny size on the CPU: the driver, the program and the
reference as a run drives them, without the look for a card."""

import time

from port_bench.core import spec

TINY = {"serve_closed": {"batch": 4, "image_size": 64, "pool": 2, "num_candidates": 64,
                         "warmup_calls": 1, "ref_block": 2, "trace_calls": 2},
        "train_update": {"images": 8, "image_size": 64, "trace_calls": 1,
                         "hyp": {"batch_size": 2, "accumulate_loss_step": 4, "num_workers": 2,
                                 "input_img_size": [64, 64]}}}


def tiny_run(cell_name, seed=2**31 + 11, seconds=0.3):
    bench = spec.load_bench()
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(bench, cell["config"])
    t = spec.traffic(cell["traffic"])
    tiny = dict(TINY[t["kind"]])
    hyp = dict(t.get("hyp", {}), **tiny.pop("hyp", {}))
    t = dict(t, **tiny, hyp=hyp)
    return spec.driver(t["kind"]).run(cell, cfg, t, seed, seconds, False, "cpu",
                                      time.perf_counter(), lambda msg: None,
                                      spec.checks(cell_name))


def cells():
    return [w["name"] for w in spec.load_bench()["workloads"]]
