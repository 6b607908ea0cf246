"""The port stands alone: `catnerf_torch` and `chip_smoke.py` import
neither jax nor any module of the JAX package, and the port never falls
back to the CPU on its own."""

from __future__ import annotations

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from catnerf_torch.config import Config
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.train.loop import TrainingSession

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "catnerf_tpu", "optax", "flax")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _sources():
    return sorted((ROOT / "catnerf_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_importing_every_module_loads_no_jax():
    """A fresh interpreter imports every catnerf_torch module (and
    chip_smoke); neither jax nor any catnerf_tpu module is then loaded."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import catnerf_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "catnerf_torch.__path__, 'catnerf_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps([names, sorted(sys.modules)]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    names, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "catnerf_torch.kernels.fused_field" in names
    assert "catnerf_torch.train.step" in names
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("module", [
    "catnerf_torch.kernels.fused_field", "catnerf_torch.models.embedding",
    "catnerf_torch.models.codenerf", "catnerf_torch.models.occupancy",
    "catnerf_torch.experimental.kernel_compare"])
def test_packed_and_xla_path_modules_load_no_jax(module):
    """Each module of the packed kernels, the XLA-path fields and the
    kernel comparison, imported alone in a fresh interpreter, loads
    neither jax nor the JAX package."""
    code = (f"import json, sys\nimport {module}\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert module in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_source_walk_covers_the_new_modules():
    names = {str(p.relative_to(ROOT)) for p in _sources()}
    assert {"catnerf_torch/experimental/kernel_compare.py",
            "catnerf_torch/models/embedding.py",
            "catnerf_torch/kernels/fused_field.py"} <= names


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and node.args:
            arg = node.args[0]
            fn = ast.unparse(node.func)
            if (fn in ("__import__", "importlib.import_module")
                    and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str) and _forbidden(arg.value)):
                bad.append(arg.value)
    assert bad == []


def test_session_without_device_raises_when_there_is_no_gpu(monkeypatch):
    """Asked for no device, the session wants a GPU; with none it raises
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    cfg.use_fused_kernels = True
    cfg.bf16_activations = False
    scene = make_scene(n_frames=1, width=16, height=12, n_categories=1,
                       insts_per_cat=1, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                        cam=scene.cam)


@pytest.mark.parametrize("change,match", [
    (dict(bf16_activations=True), "bf16_activations"),
    (dict(hidden_feature_size_bg=64), "hidden_feature_size_bg=128"),
])
def test_unsupported_configuration_raises(change, match):
    cfg = Config()
    cfg.use_fused_kernels = True
    cfg.bf16_activations = False
    for k, v in change.items():
        setattr(cfg, k, v)
    scene = make_scene(n_frames=1, width=16, height=12, n_categories=1,
                       insts_per_cat=1, seed=0)
    with pytest.raises(NotImplementedError, match=match):
        TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                        cam=scene.cam, device="cpu")


def test_default_configuration_trains_on_the_cpu():
    """`Config()` as it ships (bf16_activations=True on the XLA path,
    use_fused_kernels=False) builds a session and takes a step."""
    cfg = Config()
    assert cfg.bf16_activations and not cfg.use_fused_kernels
    scene = make_scene(n_frames=1, width=16, height=12, n_categories=1,
                       insts_per_cat=1, seed=0)
    sess = TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                           cam=scene.cam, device="cpu")
    assert math.isfinite(float(sess.step_once().total))
    assert sess.state.step == 1


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """With no CUDA device the smoke script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
