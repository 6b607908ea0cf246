"""The port's training CLI, `python -m catnerf_torch.train`, on the CPU."""

from __future__ import annotations

import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from catnerf_torch.train import __main__ as cli
from catnerf_torch.train.__main__ import main

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("extra", [[], ["--strict-parity"]],
                         ids=["default", "strict_parity"])
def test_synthetic_run_prints_one_json_line_per_log_step(capsys, tmp_path,
                                                        monkeypatch, extra):
    """The default trains `Config()` (bf16 storage on the XLA path), as the
    JAX package's `train.py --synthetic`, through the fast path;
    --strict-parity its float32 strict-parity configuration on host-staged
    batches (`step_once`)."""
    sessions = []
    session = cli.TrainingSession

    def spy(cfg, *args, **kw):
        sessions.append(session(cfg, *args, **kw))
        return sessions[-1]

    monkeypatch.setattr(cli, "TrainingSession", spy)
    assert main(["--synthetic", "--max-iter", "2", "--log-iter", "1",
                 "--logdir", str(tmp_path), "--device", "cpu", *extra]) == 0
    (sess,) = sessions
    cfg = sess.cfg
    assert not cfg.use_fused_kernels
    assert cfg.bf16_activations == (not extra)
    assert (sess._superstep is None) == bool(extra)
    assert cfg.net_hyperparams.latent_dim == 32
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["iteration"] for r in rows] == [1, 2]
    for r in rows:
        assert r["device"] == "cpu"
        assert {"total", "bg_psnr", "background/depth"} <= r.keys()
        assert sum(k.endswith("/psnr") for k in r) == 3  # 3 categories
        assert all(math.isfinite(v) for k, v in r.items()
                   if k != "device")


def test_without_synthetic_it_exits_with_a_usage_error(capsys):
    """Neither --config nor --synthetic (or both) is a usage error."""
    for argv in (["--max-iter", "1"], ["--synthetic", "--config", "x.json"]):
        with pytest.raises(SystemExit) as e:
            main([*argv, "--device", "cpu"])
        assert e.value.code == 2
        assert "one of --config or --synthetic" in capsys.readouterr().err


FIXTURE = dict(n_frames=6, width=96, height=72, n_categories=2,
               insts_per_cat=2, seed=1)


def _replica_config(tmp_path, **registration) -> str:
    """The Replica fixture of tests/test_replica_fixture.py (written by
    the port's layout writer) and room0's config pointed at it: its
    camera, a quick registration (`registration`), latent_dim 32."""
    from catnerf_torch.data.replica import write_replica_layout
    from catnerf_torch.data.synthetic import make_scene

    scene = make_scene(**FIXTURE)
    data = tmp_path / "replica"
    write_replica_layout(scene, str(data), 1.0 / 1000.0)
    with open(ROOT / "configs" / "Replica" /
              "config_replica_room0.json") as f:
        raw = json.load(f)
    raw["dataset"]["path"] = str(data)
    raw["camera"] = {"w": FIXTURE["width"], "h": FIXTURE["height"],
                     "fx": scene.cam.fx, "fy": scene.cam.fy,
                     "cx": scene.cam.cx, "cy": scene.cam.cy, "mw": 0,
                     "mh": 0}
    raw["model"]["net_hyperparams"]["latent_dim"] = 32
    raw["registration"].update(registration)
    path = tmp_path / "room.json"
    with open(path, "w") as f:
        json.dump(raw, f)
    return str(path)


def test_config_loads_registers_and_trains_a_replica_layout(
        tmp_path, capsys, monkeypatch):
    """--config on a Replica layout, on the CPU: the loader reads it,
    registers its instances with self-pretrained fields (a short
    pretraining), trains 3 steps, writes the metrics file and copies the
    config into the logdir; a second run reads the registration cache."""
    sessions = _spy_sessions(monkeypatch)
    cfg_path = _replica_config(tmp_path, load_pretrained=False,
                               pretrain_steps=20, pretrain_rays=64,
                               multi_init_pose=False)
    logdir = tmp_path / "logs"
    assert main(["--config", cfg_path, "--logdir", str(logdir),
                 "--max-iter", "3", "--log-iter", "3", "--device",
                 "cpu"]) == 0
    out = capsys.readouterr()
    assert "pretrained 4 object fields: 100 steps" in out.out
    rows = [json.loads(line) for line in out.out.splitlines()
            if line.startswith("{")]
    assert [r["iteration"] for r in rows] == [3]
    logged = [json.loads(line) for line in
              (logdir / "metrics.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in logged] == [3]
    assert logged[0]["total"] == rows[0]["total"]
    assert math.isfinite(logged[0]["total"])
    assert json.loads((logdir / "room.json").read_text()) == json.loads(
        open(cfg_path).read())
    (sess,) = sessions
    assert sess.cfg.net_hyperparams.latent_dim == 32
    assert len(sess.cls_ids) >= 2 and sess.background is not None
    assert (tmp_path / "replica" / "inst_dict.pkl").exists()

    assert main(["--config", cfg_path, "--logdir", str(logdir),
                 "--max-iter", "1", "--log-iter", "1", "--device", "cpu",
                 "--no-background"]) == 0
    assert "pretrained" not in capsys.readouterr().out
    again = sessions[1]
    assert again.background is None
    assert again.cls_ids == sess.cls_ids


def test_a_scannet_config_raises_naming_the_roadmap_item(tmp_path):
    raw = {"dataset": {"path": str(tmp_path), "format": "ScanNet"},
           "camera": {"w": 64, "h": 48, "fx": 50.0, "fy": 50.0,
                      "cx": 31.5, "cy": 23.5, "mw": 0, "mh": 0}}
    path = tmp_path / "scannet.json"
    path.write_text(json.dumps(raw))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        main(["--config", str(path), "--logdir", str(tmp_path / "logs"),
              "--device", "cpu"])


def test_config_without_a_device_wants_the_card(tmp_path, monkeypatch):
    """With no --device the CLI wants a GPU and raises where there is
    none, before it reads the dataset."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", str(tmp_path / "missing.json"), "--logdir",
              str(tmp_path / "logs")])


def test_fast_path_logs_each_chunk_and_the_rest(capsys, tmp_path):
    """--log-iter steps a run_fast call, the last call the rest; each
    logged row also goes to <logdir>/metrics.jsonl."""
    assert main(["--synthetic", "--max-iter", "3", "--log-iter", "2",
                 "--logdir", str(tmp_path), "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["iteration"] for r in rows] == [2, 3]
    logged = [json.loads(line) for line in
              (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["total"] for r in logged] == [r["total"] for r in rows]


def _spy_sessions(monkeypatch):
    sessions = []
    session = cli.TrainingSession

    def spy(cfg, *args, **kw):
        sessions.append(session(cfg, *args, **kw))
        return sessions[-1]

    monkeypatch.setattr(cli, "TrainingSession", spy)
    return sessions


def _params(sess) -> dict:
    return {k: v.detach().clone() for k, v in
            sess.state.params.state_dict().items()}


def test_save_mesh_then_resume_mesh_only_meshes_the_saved_weights(
        tmp_path, capsys, monkeypatch):
    """Checkpoints every --save-iter steps and meshes every --mesh-it
    steps; --resume --mesh-only restores the latest checkpoint before it
    meshes (the JAX package's tests/test_cli_and_ckpt.py:237 regression),
    so it writes the training run's meshes again, byte for byte."""
    sessions = _spy_sessions(monkeypatch)
    logdir = tmp_path / "logs"
    assert main(["--synthetic", "--logdir", str(logdir), "--max-iter", "4",
                 "--log-iter", "2", "--save-iter", "2", "--mesh-it", "4",
                 "--grid-dim", "32", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["iteration"] for r in rows] == [2, 4]
    assert sorted(os.listdir(logdir / "ckpt")) == ["2", "4"]
    assert sessions[0].cfg.live_voxel_size == 8.0 / 32
    mesh_dir = logdir / "scene_mesh"
    trained = {f: (mesh_dir / f).read_bytes() for f in os.listdir(mesh_dir)}
    assert len(trained) == 7  # 6 spheres and the background
    assert all(f.startswith("iteration_4_obj") for f in trained)
    for f in trained:
        (mesh_dir / f).unlink()

    assert main(["--synthetic", "--logdir", str(logdir), "--resume",
                 "--mesh-only", "--grid-dim", "32", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert f"resumed from {logdir / 'ckpt' / '4'} at iteration 4" in err
    trained_sess, restored = sessions
    assert restored.iteration == 4 and restored._superstep is None
    want = _params(trained_sess)
    got = _params(restored)
    assert all(torch.equal(got[k], want[k]) for k in want)
    again = {f: (mesh_dir / f).read_bytes() for f in os.listdir(mesh_dir)}
    assert again == trained


def test_import_reference_ckpt_then_mesh_only(tmp_path, capsys,
                                              monkeypatch):
    """--import-reference-ckpt DIR of a directory the JAX package exported
    (from its own session on the CLI's scene), then --mesh-only: the
    imported weights are the JAX session's, bitwise, and the meshes are
    named by the files' global_step."""
    import jax

    from catnerf_torch import convert
    from catnerf_tpu.config import Config as JConfig
    from catnerf_tpu.data.synthetic import make_scene as jmake_scene
    from catnerf_tpu.train import checkpoint as jckpt
    from catnerf_tpu.train.loop import TrainingSession as JSession

    jcfg = JConfig()
    jcfg.net_hyperparams.latent_dim = 32
    scene = jmake_scene(n_frames=8, width=160, height=120, n_categories=3,
                        insts_per_cat=2, seed=jcfg.seed)
    jsess = JSession(jcfg, scene.inst_dict, scene.sample_dict,
                     cam=scene.cam)
    ref_dir = tmp_path / "reference"
    jckpt.export_reference_checkpoints(jsess, str(ref_dir), 1234)

    sessions = _spy_sessions(monkeypatch)
    logdir = tmp_path / "logs"
    assert main(["--synthetic", "--logdir", str(logdir),
                 "--import-reference-ckpt", str(ref_dir), "--mesh-only",
                 "--grid-dim", "32", "--device", "cpu"]) == 0
    assert "global_step=1234" in capsys.readouterr().err
    (sess,) = sessions
    got = convert.params_to_numpy(sess.state.params)
    want = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jsess.state.params))
    for k in ("cat_pe", "cat_fc", "bg_pe", "bg_fc"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got[k],
                               want[k])
    names = sorted(os.listdir(logdir / "scene_mesh"))
    assert len(names) == 7
    assert all(n.startswith("iteration_1234_obj") for n in names)
    assert not (logdir / "ckpt").exists()


@pytest.mark.parametrize("flag", ["--save-iter", "--mesh-it", "--log-iter"])
def test_a_cadence_below_one_is_a_usage_error(capsys, flag):
    with pytest.raises(SystemExit) as e:
        main(["--synthetic", flag, "0", "--device", "cpu"])
    assert e.value.code == 2
    assert "must be >= 1" in capsys.readouterr().err


def test_fit_cli_fits_an_instance_and_meshes_it(tmp_path, capsys,
                                               monkeypatch):
    """`python -m catnerf_torch.fit --device cpu` on a 2-step checkpoint
    of the --synthetic scene: it restores the session, fits one
    instance's codes (3 steps, pose refined), prints the PSNRs and writes
    the fitted mesh (at grid 32: the adaptive grid at 5 mm voxels takes
    seconds a mesh on one core)."""
    from catnerf_torch import fit as fit_cli
    from catnerf_torch.loaders import load_scene
    from catnerf_torch.mesher import meshing

    logdir = tmp_path / "logs"
    assert main(["--synthetic", "--logdir", str(logdir), "--max-iter", "2",
                 "--log-iter", "2", "--save-iter", "2",
                 "--device", "cpu"]) == 0
    capsys.readouterr()
    _, inst_dict, _, _ = load_scene(None, synthetic=True)
    cls_id = sorted(c for c in inst_dict if c != 0)[0]
    obj = sorted(inst_dict[cls_id])[-1]
    grids = []
    monkeypatch.setattr(meshing, "adaptive_grid_dim",
                        lambda *a: grids.append(a) or 32)
    out = tmp_path / "fits"
    assert fit_cli.main(["--logdir", str(logdir), "--synthetic", "--cls",
                         str(cls_id), "--obj", str(obj), "--steps", "3",
                         "--n-rays", "32", "--optimize-pose", "--mesh",
                         "--out", str(out), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"fit obj {obj} (cls {cls_id}): 3 steps, "
                               "psnr ")
    assert lines[-1] == f"mesh: {out / f'obj{obj}_fit.obj'}"
    assert len(grids) == 1
    text = (out / f"obj{obj}_fit.obj").read_text().splitlines()
    assert sum(line.startswith("v ") for line in text) > 0
    assert sum(line.startswith("f ") for line in text) > 0
    with pytest.raises(SystemExit, match="not in the dataset"):
        fit_cli.main(["--logdir", str(logdir), "--synthetic", "--cls",
                      str(cls_id), "--obj", "999", "--device", "cpu"])
