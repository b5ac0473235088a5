"""Run one cell of the port's benchmark on the card it is started on.

    python3 -m port_bench.run --workload yolov5s.serve_b256 --seed 7 --seconds 10 --trace 0

The cell, its configuration, its traffic mix, its driver, its per-layer
metric readers and the limits of its output check are found by name
(``core/spec.py``). With ``--trace 0`` the last line of standard output
holds the cell's end-to-end metrics; with ``--trace 1`` its per-layer
metrics, read from a profiled window after the measured one. The numbers of
the output check, each beside its limit, are the last lines of standard
error and the last key of the result line.

Exits non-zero without a result line where no card (or too few) is
visible, where the program cannot be imported, and where JAX or the JAX
package was loaded in this process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):  # run as a file: the checkout's root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench.core import hygiene, spec  # noqa: E402

# every build and kernel cache at a fixed path inside the checkout: the
# port builds its CUDA library under ``build/kernels/`` there itself; these
# hold the caches of ``torch.utils.cpp_extension`` and Triton, should a
# kernel of the port come to use them
CACHE = spec.ROOT / ".port_bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(chips, peak_bytes):
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def result_line(out, cell_name, bench, trace, device):
    """The result's JSON object: metrics of the run's kind, the device, and
    the output check's numbers last."""
    metrics = {}
    if trace:
        for m in spec.per_layer(bench, cell_name):
            value = spec.reader(m["name"])(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            else:
                log(f"metric {m['name']}: nothing to read in this run")
    else:
        for m in spec.end_to_end(bench, cell_name):
            value, unit = out["e2e"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    summary = out["ctx"].get("summary")
    if trace and summary is not None:
        line["device"]["busy_s"] = summary.busy_us / 1e6
        line["device"]["window_s"] = summary.window_us / 1e6
        line["breakdown"] = summary.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out["checks"]}
    return line


def main(argv=None):
    args = parse_args(argv)
    import torch

    bench = spec.load_bench()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    driver = spec.driver(traffic["kind"])
    out = driver.run(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace), "cuda",
                     T0, log, spec.checks(args.workload))
    line = result_line(out, args.workload, bench, args.trace,
                       device_info(cell["chips"], out["peak_bytes"]))
    found = hygiene.forbidden_modules()
    if found:
        log(f"this process loaded {', '.join(found)}: the port may not use JAX")
        return 3
    for name, value, limit in out["checks"]:
        log(f"check {name} = {value!r} (limit {limit!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
