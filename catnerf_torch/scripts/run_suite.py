"""The suite runner: train, mesh and evaluate every shipped scene of a
dataset. The counterpart of the JAX package's `scripts/run_benchmark.py`,
renamed: it times nothing and is not the port's benchmark.

The reference's workflow is manual (train each scene, then run
metric/eval_3D_obj.py per dataset, README.md:60-78). This runner runs it
over the shipped configs. Scene names come from each config's dataset
path (e.g. Datasets/Replica/room_0/sequences -> room_0), the layout
`catnerf_torch.metrics.eval_scene` expects (<log_root>/<dataset>/<scene>/
scene_mesh and <data_root>/<dataset>/<scene>/habitat):

  python -m catnerf_torch.scripts.run_suite --dataset Replica \
      --data_root Datasets --log_root logs [--scenes room_0 office_0] \
      [--max-iter 2001] [--device cpu]

Each scene trains in `python -m catnerf_torch.train --config ... --logdir
...` (on the card unless --device names another), then one `python -m
catnerf_torch.metrics.eval_scene` scores them all (on the host). An
unknown scene exits non-zero. --config-root reads the configs from
another tree of the same layout (default: the repository's configs/).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def scene_name(cfg_path: str) -> str:
    """Scene dir name from the config's dataset path
    (.../<scene>/sequences -> <scene>; .../<scene> -> <scene>)."""
    with open(cfg_path) as f:
        ds_path = json.load(f)["dataset"]["path"].rstrip("/")
    parts = ds_path.split("/")
    return parts[-2] if parts[-1] == "sequences" else parts[-1]


def rebase_config(cfg_path: str, scene: str, logdir: str, data_root: str,
                  dataset: str) -> str:
    """A copy of the config in `logdir`, its dataset path re-anchored at
    `data_root`, so that training and evaluation read the same data (the
    shipped configs name repo-relative Datasets/...)."""
    with open(cfg_path) as f:
        raw = json.load(f)
    parts = raw["dataset"]["path"].rstrip("/").split("/")
    tail = parts[parts.index(scene) + 1:] if scene in parts else []
    raw["dataset"]["path"] = os.path.join(data_root, dataset, scene, *tail)
    out = os.path.join(logdir, os.path.basename(cfg_path))
    os.makedirs(logdir, exist_ok=True)
    with open(out, "w") as f:
        json.dump(raw, f, indent=1)
    return out


def mesh_iter(max_iter: int | None) -> int:
    """The iteration the scenes are meshed and evaluated at: the last
    one trained (max_iter - 1), or the shipped configs' 10,000."""
    return max_iter - 1 if max_iter is not None else 10000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m catnerf_torch.scripts.run_suite",
        description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", choices=["Replica", "ScanNet"],
                    default="Replica")
    ap.add_argument("--data_root", required=True,
                    help="root holding <dataset>/<scene> data dirs")
    ap.add_argument("--log_root", default="logs")
    ap.add_argument("--scenes", nargs="*", default=None,
                    help="scene names, e.g. room_0 scene0013_02 "
                    "(default: all configs)")
    ap.add_argument("--max-iter", type=int, default=None,
                    help="shorten training; meshing and eval follow "
                    "(mesh at max_iter-1)")
    ap.add_argument("--device", default=None,
                    help="the training runs' device: cuda (default) or cpu")
    ap.add_argument("--config-root", default=os.path.join(REPO, "configs"),
                    help="the tree holding <dataset>/*.json")
    args = ap.parse_args(argv)
    # the subprocesses run from the repository's root
    args.data_root = os.path.abspath(args.data_root)
    args.log_root = os.path.abspath(args.log_root)

    configs = sorted(glob.glob(
        os.path.join(args.config_root, args.dataset, "*.json")))
    pairs = [(scene_name(c), c) for c in configs]
    if args.scenes:
        available = {s for s, _ in pairs}
        missing = [s for s in args.scenes if s not in available]
        if missing:
            # a mistyped scene must not silently shrink the suite
            sys.exit(f"unknown scene(s) {missing} under "
                     f"{args.config_root}/{args.dataset} (available: "
                     f"{sorted(available)})")
        pairs = [(s, c) for s, c in pairs if s in set(args.scenes)]
    if not pairs:
        sys.exit(f"no configs found under {args.config_root}/"
                 f"{args.dataset}")

    it = mesh_iter(args.max_iter)
    device = [] if args.device is None else ["--device", args.device]
    for scene, cfg_path in pairs:
        logdir = os.path.join(args.log_root, args.dataset, scene)
        cfg_path = rebase_config(cfg_path, scene, logdir, args.data_root,
                                 args.dataset)
        cmd = [sys.executable, "-m", "catnerf_torch.train",
               "--config", cfg_path, "--logdir", logdir, *device]
        if args.max_iter is not None:
            cmd += ["--max-iter", str(args.max_iter), "--mesh-it", str(it)]
        print("==>", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=True, cwd=REPO)

    eval_cmd = [sys.executable, "-m", "catnerf_torch.metrics.eval_scene",
                "--data_dir", os.path.join(args.data_root, args.dataset),
                "--log_dir", os.path.join(args.log_root, args.dataset),
                "--iteration", str(it),
                "--scenes", *[s for s, _ in pairs]]
    print("==>", " ".join(eval_cmd), flush=True)
    subprocess.run(eval_cmd, check=True, cwd=REPO)
    return 0


if __name__ == "__main__":
    sys.exit(main())
