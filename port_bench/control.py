"""The readings that set a cell's output-check limits.

    python3 -m port_bench.control --workload yolox_s.serve_b16 --seeds 11,12,13 --control-seeds 3

The control is the reference in the program's place computed in the next
precision below the configuration's: TF32 convolutions and matmuls for f32
with TF32 off. It runs on the first ``--control-seeds`` seeds, at the
cell's own size, held against the f32 reference as a run holds the
program.

* A serving cell: for each seed, the weights and the pool of batches as a
  run makes them, the program's detections of every pool batch (one pass
  after the run's warm-up) and the control's (``reference/compare.py``).
* A training cell: for each seed, the control's checked updates, and a
  fault's: the reference with each micro-batch's second half left out, the
  loss the mean over the rest, in the program's place. The program's own
  readings come from the cell's runs.

Prints one JSON line a seed, then the lower reading (the largest the
program gives) and the upper reading (the smallest a control or fault
gives) of each number. Needs a card.
"""

import argparse
import json
import shutil
import sys
import time

import torch

from port_bench.core import data, spec, weights
from port_bench.drivers import serve_closed, train_update
from port_bench.reference import compare


def readings(cell_name, seed, with_control, device="cuda"):
    """(the program's numbers or None, {control or fault: its numbers})."""
    from yoloseries_tpu_torch.device import set_numeric_mode

    bench = spec.load_bench()
    cell = spec.cell(bench, cell_name)
    cfg, t = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    set_numeric_mode()
    dev = torch.device(device)
    if t["kind"] == "train_update":
        return None, train_readings(cell, cfg, t, seed, dev)
    sd = weights.seeded_state(cfg, seed, dev, t["image_size"])
    ev = serve_closed.build_program(cfg, t, sd, dev)
    pool = serve_closed.make_pool(seed, t, dev)
    for i in range(t["warmup_calls"]):
        ev(pool[i % len(pool)]).cpu()
    got = [ev(batch).cpu() for batch in pool]
    ev = None
    torch.cuda.empty_cache()
    program, control = compare.Tally(), compare.Tally()
    for batch, dets in zip(pool, got):
        want, _ = serve_closed.reference(sd, cfg, t, batch, dev)
        program.add(dets.to(dev), want)
        if with_control:
            control.add(serve_closed.reference(sd, cfg, t, batch, dev, tf32=True)[0], want)
    return program.numbers(), {"tf32": control.numbers()} if with_control else {}


def train_readings(cell, cfg, t, seed, dev):
    root = train_update.workdir(cell["name"])
    try:
        plans = None
        if t["augmentation"] == "device":  # the loader's plans, as a run's reference reads them
            trainer, img_dir, lab_dir = train_update.build_program(cfg, t, seed, root, dev)
            try:
                plans = [train_update.plan_copy(next(trainer.train_loader))
                         for _ in range(t["checked_updates"])]
            finally:
                trainer.close()
        else:
            img_dir, lab_dir, _ = data.synthetic_set(root / "data", t["images"], seed,
                                                     t["image_size"])
        sd = weights.seeded_state(cfg, seed, dev, t["image_size"])
        want = train_update.reference(sd, cfg, t, seed, img_dir, lab_dir, dev, plans=plans)
        return {name: train_update.numbers(
                    train_update.reference(sd, cfg, t, seed, img_dir, lab_dir, dev, plans=plans,
                                           **kw), want)
                for name, kw in (("tf32", {"tf32": True}), ("half", {"half": True}))}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control-seeds", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    lower, upper = {}, {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        prog, ctl = readings(args.workload, seed, i < args.control_seeds)
        print(json.dumps({"workload": args.workload, "seed": seed, "program": prog,
                          "control": ctl, "seconds": time.perf_counter() - t0}), flush=True)
        limits = spec.checks(args.workload)
        for k in limits:
            if prog is not None:
                lower[k] = max(lower.get(k, 0.0), prog[k])
            for name, numbers in ctl.items():
                upper[f"{k}.{name}"] = min(upper.get(f"{k}.{name}", float("inf")), numbers[k])
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
