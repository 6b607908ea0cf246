"""The port stands alone: `catnerf_torch` and `chip_smoke.py` import
neither jax nor any module of the JAX package, nor OpenCV or PIL (the GPU
machine has neither), not even to read a registration cache the JAX
package wrote, and the port never falls back to the CPU on its own."""

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
FORBIDDEN = ("jax", "jaxlib", "catnerf_tpu", "optax", "flax", "cv2", "PIL")


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
    "catnerf_torch.experimental.kernel_compare",
    "catnerf_torch.native.lib", "catnerf_torch.mesher.mesh",
    "catnerf_torch.mesher.meshing", "catnerf_torch.metrics.metrics3d",
    "catnerf_torch.metrics.synthetic_eval",
    "catnerf_torch.train.checkpoint",
    "catnerf_torch.experimental.e2e_quality", "catnerf_torch.data.png",
    "catnerf_torch.data.replica", "catnerf_torch.data.interop",
    "catnerf_torch.geometry.registration", "catnerf_torch.loaders",
    "catnerf_torch.train.__main__",
    "catnerf_torch.experimental.registration_check", "catnerf_torch.fit",
    "catnerf_torch.experimental.fit_check"])
def test_packed_and_xla_path_modules_load_no_jax(module):
    """Each module of the packed kernels, the XLA-path fields, the kernel
    comparison, the geometry library, the mesher, the metrics, the
    checkpoints, the quality gate and the test-time fit, imported alone
    in a fresh interpreter, loads neither jax nor the JAX package, nor
    OpenCV or PIL."""
    code = (f"import json, sys\nimport {module}\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert module in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_importing_the_mesher_loads_no_native_library():
    """The geometry library is built and loaded at its first use, never
    at import (the GPU machine builds it there, from the sources)."""
    code = ("import catnerf_torch.experimental.e2e_quality, "
            "catnerf_torch.train.__main__\n"
            "from catnerf_torch.native import lib\n"
            "print(lib._lib is None, lib.BUILD_SECONDS is None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.split() == ["True", "True"]


def test_source_walk_covers_the_new_modules():
    names = {str(p.relative_to(ROOT)) for p in _sources()}
    assert {"catnerf_torch/experimental/kernel_compare.py",
            "catnerf_torch/models/embedding.py",
            "catnerf_torch/kernels/fused_field.py",
            "catnerf_torch/native/lib.py",
            "catnerf_torch/mesher/mesh.py",
            "catnerf_torch/mesher/meshing.py",
            "catnerf_torch/metrics/metrics3d.py",
            "catnerf_torch/metrics/synthetic_eval.py",
            "catnerf_torch/train/checkpoint.py",
            "catnerf_torch/experimental/e2e_quality.py",
            "catnerf_torch/data/png.py", "catnerf_torch/data/replica.py",
            "catnerf_torch/geometry/field_pretrain.py",
            "catnerf_torch/geometry/uncertainty.py",
            "catnerf_torch/experimental/registration_check.py",
            "catnerf_torch/fit.py",
            "catnerf_torch/experimental/fit_check.py"} <= names


def test_reading_a_jax_written_cache_loads_no_forbidden_module(tmp_path):
    """A registration cache pickled by the JAX package names its classes
    (`catnerf_tpu.data.scene.OrientedBBox`); the port's tolerant reader,
    in a fresh interpreter, maps them to its own without importing them:
    afterwards neither jax, nor the JAX package, nor OpenCV or PIL is
    loaded."""
    import pickle

    import numpy as np

    from catnerf_tpu.data.scene import OrientedBBox as JBox

    box = JBox(center=np.arange(3.0), R=np.eye(3), extent=np.ones(3))
    cache = tmp_path / "inst_dict.pkl"
    with open(cache, "wb") as f:
        pickle.dump({0: {"bbox3D": box, "frame_info": []},
                     80: {1: {"T_obj": np.eye(4), "bbox3D": box,
                              "frame_info": []}}}, f)
    assert b"catnerf_tpu.data.scene" in cache.read_bytes()
    code = (
        "import json, sys\n"
        "from catnerf_torch.data.interop import load_reference_inst_dict\n"
        f"d = load_reference_inst_dict({str(cache)!r})\n"
        "b = d[80][1]['bbox3D']\n"
        "print(json.dumps([type(b).__module__, b.center.tolist(), "
        "sorted(sys.modules)]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    module, center, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert module == "catnerf_torch.data.scene"
    assert center == [0.0, 1.0, 2.0]
    assert [m for m in loaded if _forbidden(m)] == []


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


def test_the_fit_cli_without_device_raises_when_there_is_no_gpu(
        monkeypatch, tmp_path):
    """`python -m catnerf_torch.fit` asked for no device wants the card;
    with none it raises before it loads anything."""
    from catnerf_torch import fit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit.main(["--logdir", str(tmp_path), "--synthetic", "--cls", "1",
                  "--obj", "1"])


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
