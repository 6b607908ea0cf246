"""Read the numbers that set a cell's limits, on the card, in one process:
the program's sound runs on a dozen seeds or more, the control (the
reference in the traffic's lower precision in the program's place) and
each planted fault on three seeds or more, all at the cell's own size.

    python3 benchmark/tools/calibrate.py --workload room0_train \
        --seeds 12 --control-seeds 3 --fault-seeds 3 [--out FILE]

Each run is a line of JSON (the seed, what ran, each number); the last
line sums them up: for each number the largest sound reading and the
smallest control and fault readings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(0, os.path.dirname(BENCH))

FIRST_SEED = 3_000_000_000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--first-seed", type=int, default=FIRST_SEED)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchlib import compare, faults, spec, train_cell, view_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.find_cell(args.workload)
    endpoint = cell.traffic_params["endpoint"]
    drive = {"train": train_cell.run, "view": view_cell.run}[endpoint]
    planted = faults.FAULTS[endpoint]
    device = torch.device("cuda", 0)
    out = open(args.out, "w") if args.out else sys.stdout
    runs = [("sound", None, i) for i in range(args.seeds)]
    runs += [("control", None, i) for i in range(args.control_seeds)]
    runs += [("fault", name, i) for name in planted
             for i in range(args.fault_seeds)]
    summary: dict = {"sound": {}, "control": {}, "fault": {}}
    for kind, fault, i in runs:
        seed = args.first_seed + 7919 * i + (0 if kind == "sound" else
                                             1_000_000)
        t0 = time.perf_counter()
        if fault is None:
            r = drive(cell, seed, args.seconds, False, device, t0,
                      control=(kind == "control"))
        else:
            with planted[fault]():
                r = drive(cell, seed, args.seconds, False, device, t0)
        line = {"workload": cell.name, "kind": kind, "fault": fault,
                "seed": seed, "values": r["values"],
                "end_to_end": r["end_to_end"],
                "reference_s": r["reference_s"],
                **{k: r[k] for k in ("prog_losses", "chained_loss_gaps",
                                     "ref_losses", "unmoved_leaves") if k in r}}
        print(json.dumps(line), file=out, flush=True)
        agg = summary[kind]
        for name, v in r["values"].items():
            key = name if fault is None else f"{fault}.{name}"
            pick = max if kind == "sound" else min
            agg[key] = v if key not in agg else pick(agg[key], v)
    summary["limits_now"] = cell.limits
    summary["checks"] = list(compare.CHECKS)
    print(json.dumps({"summary": summary}), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
