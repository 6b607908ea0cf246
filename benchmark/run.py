"""Run one cell of the benchmark once, on the machine it is started on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
`device`, with --trace 1 `breakdown`, and last `checks`: each number that
decided `correct` beside its limit, which are also the last lines of
standard error. Without a CUDA device, or with fewer than the cell asks
for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

T_START = time.perf_counter()
BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "catnerf_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that are the JAX package or JAX."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def read_metric(name: str, readings: dict):
    """The reader benchmark/metrics/<name>.py applied to the readings."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(readings)


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout (the program
    builds its CUDA libraries under build/catnerf_torch/ itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)


def result_line(cell, readings: dict, traced: bool, device) -> dict:
    import torch

    from benchlib import compare

    correct, checks = compare.judge(readings["values"], cell.limits)
    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = read_metric(m.name, readings)
            if v is not None:
                metrics[m.name] = {"value": float(v), "unit": m.unit}
    else:
        for m in cell.end_to_end:
            metrics[m.name] = {"value": float(readings["end_to_end"][m.name]),
                               "unit": m.unit}
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    dev = {"platform": "gpu", "kind": kind,
           "count": cell.chips,
           "memory_peak_bytes": int(readings["memory_peak_bytes"])}
    out = {"correct": bool(correct), "attempted": int(readings["steps"]),
           "failed": int(readings["failed"]), "metrics": metrics,
           "device": dev}
    t = readings.get("trace")
    if traced and t is not None:
        dev["busy_s"] = t.busy_us / 1e6
        dev["window_s"] = t.window_us / 1e6
        out["breakdown"] = {"device_ops": t.top_ops(),
                            "idle_gaps": t.top_gaps()}
    out["checks"] = checks
    return out


def run_cell(cell, seed: int, seconds: float, traced: bool, device):
    """Everything of a run after the look for the card: the cell's
    endpoint driven on `device`, its readings and its result line."""
    from benchlib import train_cell, view_cell

    endpoints = {"train": train_cell.run, "view": view_cell.run}
    endpoint = cell.traffic_params["endpoint"]
    if endpoint not in endpoints:
        raise ValueError(f"{cell.traffic}: unknown endpoint {endpoint!r}")
    readings = endpoints[endpoint](cell, seed, seconds, traced, device,
                                   T_START)
    return readings, result_line(cell, readings, traced, device)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    from benchlib import compare, spec

    cell = spec.find_cell(args.workload)
    cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; nothing is measured",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    readings, out = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}; no result",
              file=sys.stderr)
        return 3
    print(f"benchmark: {cell.name} seed {args.seed}: setup "
          f"{readings['setup_s']:.2f} s, reference "
          f"{readings['reference_s']:.2f} s, unmoved leaves "
          f"{readings['unmoved_leaves']}", file=sys.stderr)
    compare.print_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
