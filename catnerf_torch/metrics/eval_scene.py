"""Scene-level aggregate evaluation CLI (a copy of the JAX package's
`metrics/eval_scene.py` on the port's `eval_obj`).

The reference README points users at `metric/eval_3D_scene.py`, which does
not exist in the reference repo (SURVEY.md §3.4 note). This provides it:
runs the per-object protocol over every scene and prints/saves the
dataset-level aggregate table (mean accuracy / completion / completion
ratio across scenes, objects and background separated).

Usage:
  python -m catnerf_torch.metrics.eval_scene --data_dir Datasets/Replica \
      --log_dir logs/Replica [--iteration 10000]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from catnerf_torch.metrics.eval_obj import (eval_scene, parse_args,
                                           resolve_dataset_and_scenes)


def main(argv=None) -> int:
    args = parse_args("python -m catnerf_torch.metrics.eval_scene", argv)

    dataset, scenes = resolve_dataset_and_scenes(args)

    table = {}
    for exp in scenes:
        arr = eval_scene(args.data_dir, args.log_dir, exp, dataset,
                         args.iteration, args.log_dir_ref)
        if arr is None:
            print(f"scene {exp}: no meshes evaluated")
            continue
        table[exp] = {
            "accuracy_cm": float(arr[0].mean()),
            "completion_cm": float(arr[1].mean()),
            "completion_ratio_pct": float(arr[2].mean()),
            "n_objects": int(arr.shape[1]),
        }

    if table:
        agg = {
            "accuracy_cm": float(np.mean([v["accuracy_cm"] for v in table.values()])),
            "completion_cm": float(np.mean([v["completion_cm"] for v in table.values()])),
            "completion_ratio_pct": float(np.mean([v["completion_ratio_pct"] for v in table.values()])),
        }
        print("\n=== scene-level results ===")
        print(f"{'scene':<16} {'acc(cm)':>8} {'comp(cm)':>9} {'ratio(%)':>9} {'#obj':>5}")
        for exp, v in table.items():
            print(f"{exp:<16} {v['accuracy_cm']:>8.2f} {v['completion_cm']:>9.2f} "
                  f"{v['completion_ratio_pct']:>9.2f} {v['n_objects']:>5}")
        print(f"{'MEAN':<16} {agg['accuracy_cm']:>8.2f} "
              f"{agg['completion_cm']:>9.2f} {agg['completion_ratio_pct']:>9.2f}")
        out = os.path.join(args.log_dir, "eval_3D_scene.json")
        with open(out, "w") as f:
            json.dump({"scenes": table, "aggregate": agg}, f, indent=2)
        print("saved", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
