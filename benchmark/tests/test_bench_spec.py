"""BENCHMARK.json against the benchmark's contract, and every file of a
cell found by its name."""

from __future__ import annotations

import json
import re

import pytest

import bench_tiny  # noqa: F401  (paths)
from benchlib import compare, spec

BENCH = spec.load_benchmark()
NAMES = ([("config", c["name"]) for c in BENCH["configs"]]
         + [("workload", w["name"]) for w in BENCH["workloads"]]
         + [("metric", m["name"]) for m in BENCH["end_to_end"]
            + BENCH["per_layer"]])
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


ENTRY_KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"},
                   {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"},
                  {"workloads"}),
}


@pytest.mark.parametrize("group", sorted(ENTRY_KEYS))
def test_entries_have_exactly_the_contract_keys(group):
    required, optional = ENTRY_KEYS[group]
    for entry in BENCH[group]:
        assert required <= set(entry) <= required | optional, (
            group, entry["name"], set(entry) ^ required)
        for key in ("why", "layer", "source"):
            if key in entry:
                assert LINE.match(entry[key]), (group, entry["name"], key)
    if group == "configs":
        for entry in BENCH[group]:
            assert len(entry["reduced"]) <= 16
            assert all(spec.NAME_RE.match(k) for k in entry["reduced"])


@pytest.mark.parametrize("kind,name", NAMES)
def test_name_is_valid(kind, name):
    assert spec.NAME_RE.match(name), (kind, name)


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entry(m):
    assert spec.UNIT_RE.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in m.get("workloads", []):
        assert w in CELLS


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.find_cell(name)
    assert cell.config_file.exists()
    assert cell.traffic_params["endpoint"] in ("train", "view")
    assert cell.limits and set(cell.limits) <= set(compare.CHECKS)
    assert LINE.match(cell.why)
    assert cell.chips == 1
    assert any(m.name == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert (spec.BENCH_DIR / "metrics" / f"{m.name}.py").exists()
        moved = [e for e in cell.end_to_end if e.name == m.moves]
        assert moved, f"{m.name} moves {m.moves}, which {name} lacks"


@pytest.mark.parametrize("conf", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_keeps_the_published_widths(conf):
    raw = json.loads((spec.ROOT / conf["file"]).read_text())
    source = conf["source"].split("/blob/HEAD/")[1]
    published = json.loads((spec.ROOT / source).read_text())
    for key, value in published.items():
        assert raw[key] == value, key
    assert set(conf["reduced"]) == set(raw["benchmark"]["reduced"])
