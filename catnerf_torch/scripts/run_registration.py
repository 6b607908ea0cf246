"""Registration alone, the counterpart of the JAX package's
`scripts/run_registration.py`.

The reference has no separate registration entry point: preprocessing
runs inside the dataset constructor and is cached (SURVEY.md §3.5, ref:
src/dataset.py:67-88). This CLI runs it, or with --force runs it again:

  python -m catnerf_torch.scripts.run_registration \
      --config configs/Replica/config_replica_room0.json [--force] \
      [--device cpu]

--force deletes the dataset's `inst_dict.pkl` first. The dataset is built
by `data/replica.get_dataset` (Replica or ScanNet, from the config's
dataset format); its device stages (field pretraining, uncertainty
scoring) run on the card unless --device names another, and with no card
and no --device it raises.
"""

from __future__ import annotations

import argparse
import os
import sys

from catnerf_torch.utils import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m catnerf_torch.scripts.run_registration",
        description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True,
                    help="a reference-schema config JSON")
    ap.add_argument("--force", action="store_true",
                    help="delete the cached inst_dict.pkl and re-run")
    ap.add_argument("--device", default=None,
                    help="where the device stages run: cuda (default) or "
                    "cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from catnerf_torch.config import Config
    from catnerf_torch.data.replica import get_dataset

    cfg = Config.from_json(args.config)
    cache = os.path.join(cfg.dataset_dir, "inst_dict.pkl")
    if args.force and os.path.exists(cache):
        os.remove(cache)
        print(f"removed {cache}")

    data = get_dataset(cfg, device=device)
    cats = {c: sorted(objs) for c, objs in data.inst_dict.items() if c != 0}
    n_obj = sum(len(v) for v in cats.values())
    print(f"registration complete: {len(cats)} categories, {n_obj} object "
          f"instances; cached at {cache}")
    for c, objs in sorted(cats.items()):
        print(f"category {c}: instances {objs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
