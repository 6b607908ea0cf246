"""The run loads nothing of JAX or the JAX package, the plain reference
imports nothing of the program, and without a card the command exits
non-zero and prints no result."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from bench_tiny import BENCH

ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "catnerf_tpu"}
REFERENCE = ["reference.py", "scene.py", "work.py", "compare.py"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_run_loads_no_jax():
    """Every module run.py and its cells import, in a fresh process,
    compared by whole top-level names."""
    code = (
        "import sys, json, runpy\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
        "import benchlib.spec, benchlib.train_cell, benchlib.trace\n"
        "import benchlib.faults\n"
        "from catnerf_torch.train.loop import TrainingSession\n"
        "from catnerf_torch.config import Config\n"
        "from catnerf_torch.data.camera import CameraInfo\n"
        "from catnerf_torch.data.device_buffer import FastDraws\n"
        "from catnerf_torch.train.step import StepDraws\n"
        "from catnerf_torch.utils import phase_timings\n"
        "import torch.profiler\n"
        f"runpy.run_path({str(BENCH / 'run.py')!r})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(json.loads(out.stdout.splitlines()[-1]))
    assert "catnerf_torch" in names and "benchlib" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_imports_nothing_of_the_program(name):
    mods = {m.split(".")[0] for m in _imports(BENCH / "benchlib" / name)}
    assert not mods & (FORBIDDEN | {"catnerf_torch"}), mods


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "room0_train",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_unknown_workload_fails():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "nope",
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
