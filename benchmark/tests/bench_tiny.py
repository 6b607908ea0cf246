"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: two
categories, two frames of 96 x 72, 120 background rays; views of
160 x 120 (the server's smallest) at 16 bins. For the tests only: the
benchmark runs every cell at its own size on the card."""

from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import spec  # noqa: E402


def tiny_cell(name: str):
    cell = spec.find_cell(name)
    raw = cell.config_raw
    raw["camera"].update({"w": 96, "h": 72, "fx": 48.0, "fy": 48.0,
                          "cx": 47.5, "cy": 35.5, "mw": 0, "mh": 0})
    raw["benchmark"]["scene"].pop("intrinsics", None)
    raw["benchmark"]["scene"].update({"frames": 2, "categories": 2})
    raw["render"]["n_per_optim_bg"] = 120
    if cell.traffic_params["endpoint"] == "view":
        cell.traffic_params.update({"width": 160, "height": 120, "bins": 16,
                                    "check_views": 2})
    return cell
