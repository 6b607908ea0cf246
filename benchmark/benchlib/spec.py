"""The benchmark's definition, found by name.

`BENCHMARK.json` at the checkout's root lists the configurations, the
cells (`workloads`) and the metrics. Everything that belongs to one
configuration, one traffic mix, one cell's limits or one per-layer metric
lives in a file of its own under `benchmark/`, found by the name
`BENCHMARK.json` gives it:

- `configs/<config>.json`: the reference's scene configuration as it is
  run, with the sizes the benchmark assumed or cut;
- `traffic/<traffic>.json`: the endpoint a cell drives and its
  parameters;
- `limits/<cell>.json`: the limit of each number that decides `correct`;
- `metrics/<metric>.py`: the reader of one per-layer metric.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    bound: float | None = None
    layer: str | None = None
    moves: str | None = None
    workloads: list[str] | None = None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    why: str
    config_file: Path
    config_raw: dict
    traffic_params: dict
    limits: dict
    end_to_end: list[Metric]
    per_layer: list[Metric]


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path}: no BENCHMARK.json at the root")
    return json.loads(path.read_text())


def _json(path: Path, what: str) -> dict:
    if not path.exists():
        raise FileNotFoundError(f"{what}: {path} is missing")
    return json.loads(path.read_text())


def _metrics(entries: list[dict]) -> list[Metric]:
    return [Metric(**entry) for entry in entries]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration, traffic,
    limits and the metrics it reports."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    config_file = root / conf["file"]
    bench_dir = root / "benchmark"
    return Cell(
        name=name, config=w["config"], traffic=w["traffic"],
        chips=int(w["chips"]), why=w["why"], config_file=config_file,
        config_raw=_json(config_file, f"configuration {w['config']}"),
        traffic_params=_json(bench_dir / "traffic" / f"{w['traffic']}.json",
                             f"traffic {w['traffic']}"),
        limits=_json(bench_dir / "limits" / f"{name}.json",
                     f"limits of {name}"),
        end_to_end=[m for m in _metrics(bench["end_to_end"])
                    if m.applies_to(name)],
        per_layer=[m for m in _metrics(bench["per_layer"])
                   if m.applies_to(name)])
