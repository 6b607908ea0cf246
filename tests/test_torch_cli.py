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
    assert main(["--synthetic", "--max-iter", "5", "--log-iter", "2",
                 "--logdir", str(tmp_path), "--device", "cpu", *extra]) == 0
    (sess,) = sessions
    cfg = sess.cfg
    assert not cfg.use_fused_kernels
    assert cfg.bf16_activations == (not extra)
    assert (sess._superstep is None) == bool(extra)
    assert cfg.net_hyperparams.latent_dim == 32
    # iterations 1-4, as train.py: max_iter 5 trains 4 steps
    assert sess.iteration == 4
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["iteration"] for r in rows] == [2, 4]
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
    pretraining), trains 3 steps (max_iter 4; one step_once a step, as
    save_iter 2000 is no multiple of log_iter 3), writes the metrics file
    and copies the config into the logdir; a second run reads the
    registration cache."""
    sessions = _spy_sessions(monkeypatch)
    cfg_path = _replica_config(tmp_path, load_pretrained=False,
                               pretrain_steps=20, pretrain_rays=64,
                               multi_init_pose=False)
    logdir = tmp_path / "logs"
    assert main(["--config", cfg_path, "--logdir", str(logdir),
                 "--max-iter", "4", "--log-iter", "3", "--device",
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
    assert sess.iteration == 3 and sess._superstep is None
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
    """A ScanNet config now loads (below); what still raises is a ScanNet
    sequence without its intrinsics when the config names none, as in
    the JAX package's loader, before any frame is read."""
    raw = {"dataset": {"path": str(tmp_path), "format": "ScanNet"},
           "camera": {"w": 64, "h": 48, "mw": 0, "mh": 0}}
    path = tmp_path / "scannet.json"
    path.write_text(json.dumps(raw))
    with pytest.raises(FileNotFoundError,
                       match="refusing to run with default intrinsics"):
        main(["--config", str(path), "--logdir", str(tmp_path / "logs"),
              "--device", "cpu"])


SCANNET_FIXTURE = dict(n_frames=5, width=96, height=72, n_categories=2,
                       insts_per_cat=2, seed=2)


def _scannet_config(tmp_path) -> str:
    """The ScanNet fixture of tests/test_scannet_fixture.py (written by
    the port's layout writer, the middle frame's pose inf) and
    scene0013_02's config pointed at it: its size, a 2-pixel crop, the
    intrinsics from the layout, the mask refinement and its caches, a
    quick registration with self-pretrained fields."""
    from catnerf_torch.data.scannet import write_scannet_layout
    from catnerf_torch.data.synthetic import make_scene

    scene = make_scene(**SCANNET_FIXTURE)
    data = tmp_path / "scannet"
    write_scannet_layout(scene, str(data), 1.0 / 1000.0)
    np.savetxt(data / "pose" / "2.txt", np.full((4, 4), np.inf))
    with open(ROOT / "configs" / "ScanNet" /
              "config_scannet_0013.json") as f:
        raw = json.load(f)
    raw["dataset"]["path"] = str(data)
    raw["camera"] = {"w": SCANNET_FIXTURE["width"],
                     "h": SCANNET_FIXTURE["height"], "mw": 2, "mh": 2}
    raw["registration"].update(load_pretrained=False, pretrain_steps=20,
                               pretrain_rays=64, multi_init_pose=False)
    path = tmp_path / "scannet.json"
    with open(path, "w") as f:
        json.dump(raw, f)
    return str(path)


def test_config_loads_registers_and_trains_a_scannet_layout(
        tmp_path, capsys, monkeypatch):
    """--config on a ScanNet layout, on the CPU: the loader reads its
    JPEG and PNG frames, refines the masks (caching them), registers
    through the TSDF route and trains 3 steps; a second run reads the
    refined-mask and registration caches and registers nothing."""
    sessions = _spy_sessions(monkeypatch)
    cfg_path = _scannet_config(tmp_path)
    data = tmp_path / "scannet"
    logdir = tmp_path / "logs"
    assert main(["--config", cfg_path, "--logdir", str(logdir),
                 "--max-iter", "4", "--log-iter", "3", "--device",
                 "cpu"]) == 0
    out = capsys.readouterr()
    assert "4 of 5 frames kept, 1 inf-pose skipped" in out.out
    assert "pretrained" in out.out
    rows = [json.loads(line) for line in out.out.splitlines()
            if line.startswith("{")]
    assert [r["iteration"] for r in rows] == [3]
    assert math.isfinite(rows[0]["total"])
    (sess,) = sessions
    assert sess.iteration == 3 and sess.cls_ids
    assert (sess.cam.width, sess.cam.height) == (92, 68)
    assert (data / "inst_dict.pkl").exists()
    assert len(list((data / "instance-refined").iterdir())) == 4
    assert len(list((data / "inst_to_cls").iterdir())) == 4
    assert main(["--config", cfg_path, "--logdir", str(logdir),
                 "--max-iter", "2", "--log-iter", "1", "--device",
                 "cpu"]) == 0
    assert "pretrained" not in capsys.readouterr().out
    assert sessions[1].cls_ids == sess.cls_ids


def test_config_without_a_device_wants_the_card(tmp_path, monkeypatch):
    """With no --device the CLI wants a GPU and raises where there is
    none, before it reads the dataset."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", str(tmp_path / "missing.json"), "--logdir",
              str(tmp_path / "logs")])


def test_fast_path_logs_each_chunk_and_the_rest(capsys, tmp_path,
                                               monkeypatch):
    """--log-iter steps a run_fast call, logged at its end; the rest, the
    steps up to max_iter - 1 after the last whole run, one step_once each
    and not logged (train.py:253-263). Each logged row also goes to
    <logdir>/metrics.jsonl."""
    sessions = _spy_sessions(monkeypatch)
    assert main(["--synthetic", "--max-iter", "6", "--log-iter", "2",
                 "--logdir", str(tmp_path), "--device", "cpu"]) == 0
    (sess,) = sessions
    assert sess.iteration == 5 and sess._superstep is not None
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["iteration"] for r in rows] == [2, 4]
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
    assert main(["--synthetic", "--logdir", str(logdir), "--max-iter", "5",
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
    assert main(["--synthetic", "--logdir", str(logdir), "--max-iter", "3",
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


# ---------------------------------------------------------------------------
# The iteration range, the dispatch rule and the loss guard, held against
# the JAX package's train.py itself: both CLIs run on the same fake
# session, which records every training call, log, checkpoint and mesh.
# ---------------------------------------------------------------------------

class _FakeMetrics:
    def __init__(self, total: float):
        self.total = total
        self.cat_psnr = np.zeros(1)


class _FakeSession:
    """What either CLI touches of a session: the training calls
    advance the iteration and return a total that is NaN when the call
    took one of the steps in `nan_steps`."""

    def __init__(self, events, nan_steps=()):
        self.events, self.nan_steps = events, set(nan_steps)
        self.iteration = 0
        self.state = type("S", (), {"step": 0})()
        self.cls_ids, self.background, self.n_per_cls = [1], None, 1
        self.batcher = type("B", (), {"n_objs_per_cls": [1]})()
        self.device = torch.device("cpu")

    def enable_fast_path(self, *args, **kw):
        self.events.append(("enable_fast_path",))

    def _advance(self, k: int, how: str):
        first = self.iteration + 1
        self.iteration += k
        self.state.step += k
        self.events.append((how, k, self.iteration))
        nan = any(s in self.nan_steps for s in range(first, first + k))
        return _FakeMetrics(float("nan") if nan else 1.0)

    def run_fast(self, n):
        return self._advance(n, "run_fast")

    def step_once(self):
        return self._advance(1, "step_once")

    def settle_prefetch(self):
        pass

    def release_prefetch(self):
        pass


def _drive(package: str, monkeypatch, tmp_path, start, max_iter, log_iter,
           save_iter, mesh_it, parity, nan_steps=()):
    """Run `package`'s CLI ("jax": train.py, "torch": the port's)
    on a fake session. Returns (events, the SystemExit message or None,
    the session)."""
    import importlib.util
    import sys

    events, made = [], []
    logdir = str(tmp_path / package)

    def session(cfg, *args, **kw):
        made.append(_FakeSession(events, nan_steps))
        return made[-1]

    class Writer:
        def __init__(self, *args):
            pass

        def log_step(self, sess, metrics, it):
            events.append(("log", it))
            return {}

        def close(self):
            pass

    def save(ckpt_dir, sess, it):
        events.append(("save", it))
        return os.path.join(ckpt_dir, str(it))

    def restore(path, sess):
        sess.iteration = sess.state.step = start

    def mesh(sess, mesh_dir, it, **kw):
        events.append(("mesh", it))
        return {}

    argv = ["--synthetic", "--logdir", logdir, "--max-iter", str(max_iter),
            "--log-iter", str(log_iter), "--save-iter", str(save_iter),
            "--mesh-it", str(mesh_it)] + (["--resume"] if start else []) + (
        ["--parity"] if parity else [])
    if package == "jax":
        from catnerf_tpu import utils as jutils
        from catnerf_tpu.config import Config as JConfig
        from catnerf_tpu.mesher import meshing as jmeshing
        from catnerf_tpu.train import checkpoint as jckpt
        from catnerf_tpu.train import logging as jlogging
        from catnerf_tpu.train import loop as jloop

        spec = importlib.util.spec_from_file_location("jax_train_cli",
                                                      ROOT / "train.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        monkeypatch.setattr(mod, "load_scene",
                            lambda *a, **kw: (JConfig(), {}, {}, None))
        monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
        monkeypatch.setattr(jloop, "TrainingSession", session)
        monkeypatch.setattr(jlogging, "MetricsWriter", Writer)
        monkeypatch.setattr(jmeshing, "mesh_scene", mesh)
        monkeypatch.setattr(jckpt, "save_session_checkpoint", save)
        monkeypatch.setattr(jckpt, "latest_checkpoint", lambda d: "latest")
        monkeypatch.setattr(jckpt, "restore_session_checkpoint", restore)
        monkeypatch.setattr(sys, "argv", ["train.py", *argv])
        run = mod.main
    else:
        from catnerf_torch.config import Config

        monkeypatch.setattr(cli, "load_scene",
                            lambda *a, **kw: (Config(), {}, {}, None))
        monkeypatch.setattr(cli, "TrainingSession", session)
        monkeypatch.setattr(cli, "MetricsWriter", Writer)
        monkeypatch.setattr(cli, "mesh_scene", mesh)
        monkeypatch.setattr(cli.ckpt_mod, "save_session_checkpoint", save)
        monkeypatch.setattr(cli.ckpt_mod, "latest_checkpoint",
                            lambda d: "latest")
        monkeypatch.setattr(cli.ckpt_mod, "restore_session_checkpoint",
                            restore)

        def run():
            return main([*argv, "--device", "cpu"])
    try:
        run()
        message = None
    except SystemExit as e:
        message = str(e)
    return events, message, made[0]


#: (start, max_iter, log_iter, save_iter, mesh_it, --parity)
SCHEDULES = [
    (0, 10001, 100, 2000, 10000, False),  # room0's config: 10,000 steps
    (0, 5, 2, 2, 4, False),
    (0, 6, 2, 2, 4, False),               # a step_once after the runs
    (0, 4, 1, 1, 1, False),               # log_iter 1: step_once only
    (0, 10, 3, 2, 3, False),              # save_iter off log_iter
    (0, 10, 2, 4, 3, False),              # mesh_it off log_iter
    (3, 11, 3, 3, 3, False),              # resumed on a multiple
    (2, 10, 3, 3, 3, False),              # resumed off a multiple
    (0, 1, 2, 2, 2, False),               # nothing to train
    (0, 7, 2, 2, 2, True),                # --parity
]


@pytest.mark.parametrize("start,max_iter,log_iter,save_iter,mesh_it,parity",
                         SCHEDULES)
def test_the_iteration_range_and_dispatch_are_train_pys(
        tmp_path, monkeypatch, capsys, start, max_iter, log_iter, save_iter,
        mesh_it, parity):
    """The steps trained (and the path of each), logged, saved and
    meshed are train.py's (ref: train.py:157-160, 253-265), call for
    call: iterations start+1 ... max_iter-1, actions at multiples of their
    cadence only; `cli.schedule` says the same."""
    case = (start, max_iter, log_iter, save_iter, mesh_it, parity)
    jax_events, _, _ = _drive("jax", monkeypatch, tmp_path, *case)
    events, message, sess = _drive("torch", monkeypatch, tmp_path, *case)
    assert message is None
    assert events == jax_events
    assert sess.iteration == max(start, max_iter - 1)
    trained = [e for e in events if e[0] in ("run_fast", "step_once")]
    fast = cli.uses_fast_path(_Cadence(*case[1:5]), start, parity)
    assert [(e[2], e[0]) for e in trained] == cli.schedule(
        _Cadence(*case[1:5]), start, fast)
    assert (("enable_fast_path",) in events) == fast
    for name, every in (("log", log_iter), ("save", save_iter),
                        ("mesh", mesh_it)):
        assert [e[1] for e in events if e[0] == name] == [
            it for it in range(start + 1, max_iter) if it % every == 0
            and (not fast or it % log_iter == 0)]


class _Cadence:
    def __init__(self, max_iter, log_iter, save_iter, mesh_it):
        self.max_iter, self.log_iter = max_iter, log_iter
        self.save_iter, self.mesh_it = save_iter, mesh_it


@pytest.mark.parametrize("case,nan_steps", [
    ((0, 9, 2, 2, 100, True), (2,)),    # parity: two steps behind
    ((0, 11, 2, 100, 100, False), (3,)),  # in a run of the fast path
    ((0, 6, 2, 100, 100, True), (5,)),  # the last step: the final flush
], ids=["parity", "fast", "flush"])
def test_the_loss_guard_stops_where_train_pys_does(tmp_path, monkeypatch,
                                                   capsys, case, nan_steps):
    """A NaN total stops both CLIs at the same call, with the same
    post-mortem checkpoint and the same message (ref: train.py:188-215)."""
    jax_events, jax_message, _ = _drive("jax", monkeypatch, tmp_path, *case,
                                        nan_steps=nan_steps)
    events, message, sess = _drive("torch", monkeypatch, tmp_path, *case,
                                   nan_steps=nan_steps)
    assert jax_message is not None and "loss explosion" in jax_message
    assert message == jax_message.replace(str(tmp_path / "jax"),
                                          str(tmp_path / "torch"))
    assert events == jax_events
    assert events[-1] == ("save", sess.iteration)


def test_an_injected_nan_ends_the_run_with_a_post_mortem_checkpoint(
        tmp_path, monkeypatch, capsys):
    """A NaN written into one background weight before training: the
    first step's total is NaN; two steps later the guard saves the state
    at iteration 3 and exits with train.py's message."""
    session = cli.TrainingSession

    def poisoned(cfg, *args, **kw):
        sess = session(cfg, *args, **kw)
        with torch.no_grad():
            next(sess.state.params.bg_fc.parameters()).view(-1)[0] = \
                float("nan")
        return sess

    monkeypatch.setattr(cli, "TrainingSession", poisoned)
    logdir = tmp_path / "logs"
    with pytest.raises(SystemExit) as e:
        main(["--synthetic", "--logdir", str(logdir), "--max-iter", "6",
              "--log-iter", "5", "--parity", "--device", "cpu"])
    ckpt = logdir / "ckpt" / "3"
    assert str(e.value) == (
        f"loss explosion detected at iteration 1 (total=nan); post-mortem "
        f"state snapshot (iteration 3, 2 steps past the explosion — may be "
        f"poisoned) saved to {ckpt}")
    assert ckpt.exists()


def test_parity_trains_step_once_on_the_epoch_cursor(tmp_path, capsys,
                                                     monkeypatch):
    """--parity trains every step with step_once for a config whose
    cadences would take the fast path: its logged total is a session's
    own second step_once, bitwise."""
    from catnerf_torch.loaders import load_scene

    sessions = _spy_sessions(monkeypatch)
    assert main(["--synthetic", "--logdir", str(tmp_path), "--max-iter",
                 "3", "--log-iter", "2", "--parity", "--device",
                 "cpu"]) == 0
    (sess,) = sessions
    assert sess._superstep is None and sess.iteration == 2
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["iteration"] for r in rows] == [2]
    cfg, inst_dict, sample_dict, cam = load_scene(None, synthetic=True)
    ref = cli.TrainingSession(cfg, inst_dict, sample_dict, cam=cam,
                              device="cpu")
    ref.step_once()
    assert rows[0]["total"] == float(ref.step_once().total)
    ref.release_prefetch()


def test_trace_writes_a_profiler_trace_of_the_first_run(tmp_path, capsys):
    """--trace: the first run_fast call under torch.profiler, a Chrome
    trace of its operators under <logdir>/trace."""
    assert main(["--synthetic", "--logdir", str(tmp_path), "--max-iter",
                 "3", "--log-iter", "2", "--trace", "--device", "cpu"]) == 0
    assert "device trace written to" in capsys.readouterr().err
    (path,) = (tmp_path / "trace").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(str(ev.get("name", "")).startswith("aten::mm")
               for ev in events)


@pytest.mark.parametrize("flag", [["--train-sharded"], ["--mesh-sharded"]])
def test_the_sharded_flags_raise_naming_their_item(flag, tmp_path, capsys):
    """The sharding flags raised until parallel/ existed (ROADMAP.md item
    4g, done); in one process (no torchrun) each now runs unsharded and
    says so, as train.py does with one device. Under torchrun:
    tests/test_torch_parallel.py."""
    assert main(["--synthetic", *flag, "--device", "cpu", "--logdir",
                 str(tmp_path), "--max-iter", "1", "--log-iter", "2",
                 "--save-iter", "2", "--mesh-it", "2"]) == 0
    assert (f"{flag[0]}: single device visible, running unsharded"
            in capsys.readouterr().err)
