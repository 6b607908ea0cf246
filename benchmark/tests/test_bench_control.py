"""What decides `correct` fails where it must: the control (the reference
in the traffic's lower precision in the program's place) and each fault
planted under the timed path, with the rest of a run driven as the
command drives it, the look for a card skipped. At a tiny size on the
CPU; the limits are the cells' own."""

from __future__ import annotations

import importlib.util

import pytest
import torch

from bench_tiny import BENCH, tiny_cell
from benchlib import faults


def _run_module():
    spec = importlib.util.spec_from_file_location("bench_run",
                                                  BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _result(name, **kw):
    from benchlib import train_cell, view_cell

    run = _run_module()
    cell = tiny_cell(name)
    drive = {"train": train_cell.run,
             "view": view_cell.run}[cell.traffic_params["endpoint"]]
    dev = torch.device("cpu")
    readings = drive(cell, 2**31 + 23, 0.2, False, dev, 0.0, **kw)
    return run.result_line(cell, readings, False, dev)


CELLS = ["room0_train", "room0_train_bf16", "room0_view"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _result(name)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["checks"] and out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    out = _result(name, control=True)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name,fault", [
    ("room0_train", "frozen"), ("room0_train", "half_batch"),
    ("room0_train", "store_depth"), ("room0_view", "objects_dropped")])
def test_fault_is_not_correct(name, fault):
    endpoint = "view" if name.endswith("view") else "train"
    with faults.FAULTS[endpoint][fault]():
        out = _result(name)
    assert not out["correct"], (fault, out["checks"])
