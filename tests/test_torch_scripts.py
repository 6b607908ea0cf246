"""The port's last entry points on the CPU: the registration CLI
(`catnerf_torch.scripts.run_registration`) and the suite runner
(`catnerf_torch.scripts.run_suite`) on the Replica layout fixture of
tests/test_torch_replica.py, its registration replaced by that file's
ground-truth stand-in, and the room-scale run
(`catnerf_torch.experimental.stress_scale`) at a tiny size against the JAX
script's keys and samples-per-step formula."""

from __future__ import annotations

import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from catnerf_torch.experimental import stress_scale
from catnerf_torch.geometry import obb as tobb
from catnerf_torch.geometry import registration as treg
from catnerf_torch.scripts import run_registration, run_suite

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_eval import sphere_mesh  # noqa: E402
from test_torch_replica import (_gt_registration, _layout,  # noqa: E402
                                _scene, _write_config)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def fake_registration(monkeypatch):
    """The ground-truth stand-in for the registration stage; the list of
    devices it was called with."""
    calls = []

    def fake(i, s, c, cfg, name, device):
        calls.append(str(device))
        _gt_registration(i, s, c, treg, tobb)

    monkeypatch.setattr(treg, "run_registration", fake)
    return calls


def test_run_registration_registers_forces_and_reuses(tmp_path, capsys,
                                                      fake_registration):
    """The first run registers and writes inst_dict.pkl; --force deletes it
    and registers again; without --force the cache is read back."""
    _layout(tmp_path)
    cfg = tmp_path / "cfg.json"
    _write_config(cfg, tmp_path)
    cache = tmp_path / "inst_dict.pkl"
    argv = ["--config", str(cfg), "--device", "cpu"]
    assert run_registration.main(argv) == 0
    assert fake_registration == ["cpu"] and cache.exists()
    first = cache.read_bytes()
    out = capsys.readouterr().out
    assert "registration complete: 2 categories, 4 object instances" in out
    assert "category 80: instances [1, 2]" in out

    cache.write_bytes(first + b"stale")
    assert run_registration.main(argv + ["--force"]) == 0
    assert fake_registration == ["cpu", "cpu"]
    assert f"removed {cache}" in capsys.readouterr().out
    assert cache.read_bytes() == first

    assert run_registration.main(argv) == 0
    assert fake_registration == ["cpu", "cpu"]
    assert "2 categories, 4 object instances" in capsys.readouterr().out


def _suite_tree(root: Path) -> tuple[Path, Path]:
    """configs/Replica/<room_0's config> naming Datasets/Replica/room_0/
    sequences (the fixture's camera, a 32-voxel mesh grid), the layout
    registered at data/Replica/room_0/sequences and GT sphere meshes in
    its habitat/. Returns (config root, data root)."""
    data = root / "data"
    seq = data / "Replica" / "room_0" / "sequences"
    seq.mkdir(parents=True)
    _layout(seq)
    cfg = root / "cfg.json"
    _write_config(cfg, seq)
    assert run_registration.main(["--config", str(cfg), "--device",
                                  "cpu"]) == 0
    raw = json.loads(cfg.read_text())
    raw["dataset"]["path"] = "Datasets/Replica/room_0/sequences"
    raw["vis"]["grid_dim"] = 32
    configs = root / "configs"
    (configs / "Replica").mkdir(parents=True)
    (configs / "Replica" / "config_replica_room0.json").write_text(
        json.dumps(raw))
    gt = data / "Replica" / "room_0" / "habitat"
    gt.mkdir()
    for s in _scene().spheres:
        sphere_mesh(s.radius, s.center).export_ply(
            str(gt / f"mesh_semantic.ply_{s.inst_id}.ply"))
    return configs, data


def test_run_suite_trains_meshes_and_evaluates(tmp_path, monkeypatch,
                                               capsys, fake_registration):
    """--max-iter 3 on the CPU: the training CLI reads the registration
    cache, meshes at iteration 2 under <log_root>/Replica/room_0/
    scene_mesh, and eval_scene writes the aggregate; the training run got
    --device."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    configs, data = _suite_tree(tmp_path)
    logs = tmp_path / "logs"
    assert run_suite.main([
        "--dataset", "Replica", "--data_root", str(data), "--log_root",
        str(logs), "--max-iter", "3", "--device", "cpu", "--config-root",
        str(configs), "--scenes", "room_0"]) == 0
    out = capsys.readouterr().out
    assert "catnerf_torch.train --config" in out and "--device cpu" in out
    assert "catnerf_torch.metrics.eval_scene" in out
    meshes = sorted(p.name for p in (logs / "Replica" / "room_0" /
                                     "scene_mesh").glob("iteration_2_*"))
    assert "iteration_2_obj0.obj" in meshes and len(meshes) >= 2
    rebased = json.loads((logs / "Replica" / "room_0" /
                          "config_replica_room0.json").read_text())
    assert rebased["dataset"]["path"] == str(
        data / "Replica" / "room_0" / "sequences")
    table = json.loads((logs / "Replica" / "eval_3D_scene.json").read_text())
    assert table["scenes"]["room_0"]["n_objects"] >= 1
    assert np.isfinite(table["aggregate"]["accuracy_cm"])
    assert fake_registration == ["cpu"]  # the suite reused the cache


def test_run_suite_exits_on_an_unknown_scene(tmp_path):
    with pytest.raises(SystemExit) as e:
        run_suite.main(["--data_root", str(tmp_path), "--log_root",
                        str(tmp_path / "logs"), "--scenes", "room_0",
                        "nowhere"])
    assert e.value.code not in (0, None)
    assert "nowhere" in str(e.value.code)
    assert not (tmp_path / "logs").exists()


def test_suite_scene_names_and_mesh_iteration():
    """Every shipped config names a distinct scene; --max-iter N meshes at
    N - 1, else at the configs' 10,000."""
    for dataset in ("Replica", "ScanNet"):
        configs = sorted((ROOT / "configs" / dataset).glob("*.json"))
        names = [run_suite.scene_name(str(c)) for c in configs]
        assert len(set(names)) == len(configs) > 0
    assert run_suite.scene_name(
        str(ROOT / "configs" / "Replica" / "config_replica_room0.json")) \
        == "room_0"
    assert run_suite.mesh_iter(3) == 2 and run_suite.mesh_iter(None) == 10000


def _jax_result_keys() -> set[str]:
    """The keys scripts/stress_scale.py writes into its JSON line."""
    tree = ast.parse((ROOT / "scripts" / "stress_scale.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript) and isinstance(node.value,
                                                           ast.Name)
                and node.value.id == "result"
                and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
        elif (isinstance(node, ast.Assign) and isinstance(node.value,
                                                          ast.Dict)
              and any(isinstance(t, ast.Name) and t.id == "result"
                      for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
    return keys


def test_stress_scale_at_a_tiny_size(capsys):
    """2 frames of 48 x 36, 2 categories, 100 steps, grid 32, one object
    meshed, on the CPU: one JSON line with every key of the JAX script's
    and the port's own, each cut listed under `reduced`, the JAX formula's
    samples a step on the same scene, and a finite loss."""
    from catnerf_tpu.config import Config as JConfig
    from catnerf_tpu.data.synthetic import make_scene as jmake_scene
    from catnerf_tpu.train.loop import TrainingSession as JSession

    args = dict(frames=2, width=48, height=36, categories=2, iters=100,
                grid_dim=32)
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in args.items()]
    assert stress_scale.main(argv + ["--mesh-objects", "1",
                                     "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(line)
    keys = _jax_result_keys()
    assert len(keys) > 25 and keys <= set(result)
    assert {"peak_device_mb", "device", "reduced",
            "store_rays_capped"} <= set(result)
    assert result["device"] == "cpu" and result["peak_device_mb"] is None
    assert result["reduced"] == [
        "width 1200 -> 48", "height 680 -> 36", "frames 100 -> 2",
        "categories 20 -> 2", "iters 10000 -> 100", "grid_dim 256 -> 32",
        "mesh_objects all -> 1"]
    assert result["cap_rays_per_cat"] == result["cap_rays_bg"] == 0
    assert not result["store_rays_capped"]
    assert result["n_categories_loaded"] == 2 and result["n_meshed"] == 1
    assert np.isfinite(result["final_total"])
    assert "store_upload_wait" in result["fast_phase_s"]

    cfg = JConfig()
    cfg.net_hyperparams.latent_dim = 32
    cfg.grid_dim = args["grid_dim"]
    scene = jmake_scene(n_frames=2, width=48, height=36, n_categories=2,
                        insts_per_cat=2, seed=0)
    sess = JSession(cfg, scene.inst_dict, scene.sample_dict, cam=scene.cam)
    n_cls = len(sess.cls_ids)
    want = (sess.n_per_cls * n_cls * (cfg.n_bins + cfg.n_bins_cam2surface)
            + cfg.n_per_optim_bg * (cfg.n_bins + cfg.n_bins_cam2surface_bg))
    assert result["samples_per_step"] == want
    assert result["cat_rays_total"] == sum(c.buffer.n
                                           for c in sess.categories)
    assert result["bg_rays_total"] == sess.background.buffer.n
