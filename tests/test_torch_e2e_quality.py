"""The port's end-to-end quality gate (`catnerf_torch.experimental.
e2e_quality`) on the CPU at a tiny length, and its flip rule."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from catnerf_torch.experimental import e2e_quality as e2e

torch.set_num_threads(1)


def test_the_gate_trains_meshes_and_scores_all_six_spheres(tmp_path,
                                                           capsys,
                                                           monkeypatch):
    """10 steps and 32-voxel grids: no quality bound at that length, but
    the whole path runs and prints its one JSON line, with the exit code
    of the gate's pass rule. The render readout at 2 bins (its 64 take
    ~100 s a frame on one CPU core)."""
    monkeypatch.setattr(e2e, "RENDER_BINS", 2)
    rc = e2e.main(["--device", "cpu", "--iters", "10", "--grid-dim", "32",
                   "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert rc == (0 if e2e.passes(result) else 1)
    assert result["metric"] == "e2e_synthetic_quality"
    assert result["iters"] == 10 and result["device"] == "cpu"
    assert result["n_objects"] == 6
    assert result["n_meshed"] == sum(v is not None for v in
                                     result["per_object"].values())
    assert result["n_meshed"] >= 1
    assert {"grid_eval", "marching_cubes", "vertex_color",
            "export"} <= result["mesh_phase_s"].keys()
    assert len(list(tmp_path.glob("iteration_10_obj*.obj"))) >= \
        result["n_meshed"]
    psnr = result["render_psnr"]
    assert len(psnr) == 2 and all(np.isfinite(psnr)) and min(psnr) > 0


#: the keys of the JAX gate's fit_holdout dict (scripts/e2e_quality.py:
#: 392-405)
FIT_HOLDOUT_KEYS = {"held_out", "path", "registration_chamfer",
                    "pose_center_err_cm", "pose_scale_err_pct", "fit_steps",
                    "psnr_prior_init", "psnr_after_fit", "mesh", "wall_s"}


def test_the_fit_holdout_gate_runs_the_new_instance_path(tmp_path, capsys,
                                                        monkeypatch):
    """--fit-holdout at 10 steps, 32-voxel grids and a 5-step fit: the
    first category's last sphere is left out of training and scored only
    through the fit (registration, fit with pose refinement, mesh), with
    the JAX gate's keys, and the exit code of its pass rule."""
    monkeypatch.setattr(e2e, "RENDER_BINS", 2)
    monkeypatch.setattr(e2e, "FIT_STEPS", 5)
    rc = e2e.main(["--device", "cpu", "--iters", "10", "--grid-dim", "32",
                   "--out", str(tmp_path), "--fit-holdout"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert rc == (0 if e2e.passes(result) else 1)
    assert result["metric"] == "e2e_fit_holdout"
    held_cls, held = e2e.holdout(e2e.make_scene(
        **{**e2e.SCENE, "insts_per_cat": e2e.HOLDOUT_INSTS}).inst_dict)
    assert result["n_objects"] == 9
    assert sorted(int(k) for k in result["per_object"]) == sorted(
        i for i in range(1, 10) if i != held)
    fh = result["fit_holdout"]
    assert set(fh) == FIT_HOLDOUT_KEYS
    assert fh["held_out"] == held and fh["path"] == "gt_pose"
    assert fh["fit_steps"] == 5
    assert np.isfinite([fh["registration_chamfer"], fh["pose_center_err_cm"],
                        fh["psnr_prior_init"], fh["psnr_after_fit"]]).all()
    assert fh["mesh"] is None or set(fh["mesh"]) == {
        "accuracy_cm", "completion_cm", "completion_ratio_pct"}


def test_the_registered_fit_holdout_raises_naming_its_item(tmp_path,
                                                           monkeypatch):
    """The registered fit-holdout on the ScanNet layout (it raised before
    the ScanNet loader was ported) runs at a tiny size: one category of 3
    spheres in 6 frames of 96 x 72, the last frame's pose inf, a 20-step
    pretraining, 10 steps and a 5-step fit. The held-out sphere is scored
    in the loader's ids (inst + 1, cls + 50), through the full layout
    read without registration; what still raises is a category that
    registration split, with the JAX gate's message (below)."""
    monkeypatch.setattr(e2e, "SCENE", dict(n_frames=5, width=160,
                                           height=120, n_categories=1,
                                           insts_per_cat=2))
    monkeypatch.setattr(e2e, "RENDER_BINS", 2)
    monkeypatch.setattr(e2e, "FIT_STEPS", 5)
    cfg, _, _ = e2e.resolve_modes(grid_dim=32)
    cfg.pretrain_steps, cfg.pretrain_rays = 20, 64
    cfg.multi_init_pose = False
    calls = []
    run_fit_holdout = e2e.run_fit_holdout

    def spy(sess, scene, held, **kw):
        calls.append((held, kw))
        return run_fit_holdout(sess, scene, held, **kw)

    monkeypatch.setattr(e2e, "run_fit_holdout", spy)
    run = e2e.run(10, 32, device="cpu", out=str(tmp_path), registered=True,
                  fit_holdout=True, cfg=cfg, dataset="scannet")
    result = run.result
    assert result["metric"] == "e2e_synthetic_quality_registered_scannet"
    (((held_cls, held), kw),) = calls
    assert kw["loader_held"] == (held_cls + 50, held + 1)
    data, data_full = kw["data"], kw["data_full"]
    assert data.name == data_full.name == "scannet"
    assert data.n_img == data_full.n_img == 4   # one inf pose skipped
    trained = {o for c, objs in data.inst_dict.items() if c for o in objs}
    assert held + 1 not in trained and trained == {1 + 1, 2 + 1}
    fh = result["fit_holdout"]
    assert set(fh) == FIT_HOLDOUT_KEYS
    assert fh["held_out"] == held + 1 and fh["path"] == "registered"
    assert sorted(int(k) for k in result["per_object"]) == [2, 3]
    assert {"decode", "resize", "refine", "normals", "image", "components",
            "fill", "stage1", "align"} <= result["registration_s"].keys()


@pytest.mark.parametrize("refined", [True, False],
                         ids=["refined", "no-refined-mask"])
def test_the_registered_scannet_gate(tmp_path, monkeypatch, refined):
    """--registered --dataset scannet [--no-refined-mask] at 10 steps and
    32-voxel grids on 2 categories of 2 spheres in 6 frames of 96 x 72:
    the ScanNet layout, the last frame's pose inf, the 4-pixel crop, the
    mask refinement on or off, registration through the TSDF route, and
    the spheres scored in the loader's ids; the CLI hands both flags to
    `run`."""
    monkeypatch.setattr(e2e, "SCENE", dict(n_frames=6, width=96, height=72,
                                           n_categories=2, insts_per_cat=2))
    monkeypatch.setattr(e2e, "RENDER_BINS", 2)
    cfg, _, _ = e2e.resolve_modes(grid_dim=32)
    cfg.pretrain_steps, cfg.pretrain_rays = 20, 64
    cfg.multi_init_pose = False
    run = e2e.run(10, 32, device="cpu", out=str(tmp_path), registered=True,
                  cfg=cfg, dataset="scannet", refined_mask=refined)
    result, sess = run.result, run.session
    data_cfg = sess.cfg
    assert data_cfg.dataset_format == "ScanNet"
    assert (data_cfg.mw, data_cfg.mh) == (4, 4)
    assert data_cfg.use_refined_mask == refined
    assert (sess.cam.width, sess.cam.height) == (88, 64)
    assert len(sess.sample_dict) == 5
    assert result["metric"] == "e2e_synthetic_quality_registered_scannet"
    assert result["n_objects"] == 4
    assert sorted(s.inst_id for s in run.scene.spheres) == [2, 3, 4, 5]
    scene = e2e.make_scene(**e2e.SCENE)
    assert sorted({s.cls_id for s in run.scene.spheres}) == sorted(
        c + 50 for c in scene.inst_dict if c)
    assert sorted(int(k) for k in result["per_object"]) == [2, 3, 4, 5]
    assert set(result["registration"]) <= {2, 3, 4, 5}
    seconds = result["registration_s"]
    assert ("refine" in seconds) == refined
    assert {"frames", "decode", "resize", "stage1", "align"} <= seconds.keys()

    seen = []
    monkeypatch.setattr(e2e, "run", lambda *a, **k: seen.append(k) or
                        e2e.GateRun(result, None, None, None))
    argv = ["--device", "cpu", "--registered", "--dataset", "scannet"]
    e2e.main(argv + ([] if refined else ["--no-refined-mask"]))
    assert seen[0]["dataset"] == "scannet"
    assert seen[0]["refined_mask"] == refined


@pytest.mark.parametrize("change,ok", [
    ({}, True),
    ({"n_meshed": 9}, False),           # 9 objects, one held out: 8 trained
    ({"fit_holdout": {"mesh": None}}, False),
    ({"fit_holdout": {"mesh": {"accuracy_cm": 5.0}}}, False),
    ({"fit_holdout": {"psnr_after_fit": 20.0}}, False),
])
def test_the_fit_holdout_pass_rule_is_the_jax_gates(change, ok):
    """scripts/e2e_quality.py:439-447: the trained objects all meshed and
    in the band, the fitted mesh present and under 5 cm in accuracy, and
    the fit's PSNR above its prior's."""
    fh = {"mesh": {"accuracy_cm": 0.6}, "psnr_prior_init": 20.0,
          "psnr_after_fit": 25.0}
    result = {"n_meshed": 8, "n_objects": 9, "mean_accuracy_cm": 1.0,
              "mean_completion_cm": 1.0, "mean_completion_ratio_pct": 99.0,
              "fit_holdout": {**fh, **change.pop("fit_holdout", {})},
              **change}
    assert e2e.passes(result) == ok


def test_the_pass_rule_is_the_jax_gates():
    ok = {"n_meshed": 6, "n_objects": 6, "mean_accuracy_cm": 4.9,
          "mean_completion_cm": 4.9, "mean_completion_ratio_pct": 80.1}
    assert e2e.passes(ok)
    for k, v in (("n_meshed", 5), ("mean_accuracy_cm", 5.0),
                 ("mean_completion_cm", 5.1),
                 ("mean_completion_ratio_pct", 80.0)):
        assert not e2e.passes({**ok, k: v})


def test_count_flips_allows_one_quantum_at_a_rounding_boundary_only():
    occ = np.zeros(1000, np.float32)  # one flip in 1,000 is 0.1%
    occ[:4] = [0.2, 100.5 / 255, 0.6, 200.5 / 255]  # 51, 100.5, 153
    a = np.round(occ * 255).astype(np.uint8)
    b = a.copy()
    b[1] += 1  # occ * 255 on a .5 boundary: allowed
    assert e2e.count_flips(occ, a, b)["u8_flips"] == 1
    b[2] += 1  # away from a boundary
    with pytest.raises(AssertionError, match="away from a rounding"):
        e2e.count_flips(occ, a, b)
    b = a.copy()
    b[3] += 2
    with pytest.raises(AssertionError, match="more than one quantum"):
        e2e.count_flips(occ, a, b)


def test_count_flips_bounds_the_share_of_flips():
    occ = np.full(1000, 100.5 / 255, np.float32)
    a = np.full(1000, 100, np.uint8)
    b = a.copy()
    b[0] = 101
    e2e.count_flips(occ, a, b)
    b[1] = 101
    with pytest.raises(AssertionError, match="flipped"):
        e2e.count_flips(occ, a, b)


def test_carve_boundary_marks_half_pixels_and_the_depth_margin():
    """A 4 x 3 image seen head-on (fx = fy = 1, cx = cy = 0): a point at
    pixel x = 1.5 and one whose depth test is on the margin are marked; a
    point at pixel (1.2, 1.2), well in front of its depth, is not."""
    depths = np.full((1, 4, 3), 2.0, np.float32)
    T_wc = np.eye(4, dtype=np.float32)[None]
    K = (1.0, 1.0, 0.0, 0.0)
    z = 1.0
    pts = np.array([[1.5 * z, 1.2 * z, z],     # on a .5 pixel boundary
                    [1.2 * 1.9, 1.2 * 1.9, 1.9],  # z = obs - margin
                    [1.2 * z, 1.2 * z, z]])
    near = e2e.carve_boundary(pts, depths, T_wc, K, margin=0.1)
    assert near.tolist() == [True, True, False]
    seen_a = np.array([True, False, True])
    seen_b = np.array([False, True, True])
    occ = np.zeros(3, np.float32)
    u8 = np.zeros(3, np.uint8)
    with pytest.raises(AssertionError, match="flipped"):  # 2 of 3 voxels
        e2e.count_flips(occ, u8, u8, seen_a, seen_b, near)
    seen_b = np.array([True, False, False])
    with pytest.raises(AssertionError, match="carve bits differ"):
        e2e.count_flips(occ, u8, u8, seen_a, seen_b, near)


# ---------------------------------------------------------------------------
# The JAX gate's other modes (ref: scripts/e2e_quality.py:36-90, 136-155,
# 187-250, 259-282, 327-374, 429-433)
# ---------------------------------------------------------------------------

class _FakeMetrics:
    def __init__(self):
        self.cat_psnr = np.zeros(2)


class _FakeJaxSession:
    """What the JAX gate touches of a session, recording its config and
    which dispatch trained it."""

    def __init__(self, cfg, inst_dict, sample_dict, cam=None, **kw):
        self.cfg, self.sample_dict, self.cam = cfg, sample_dict, cam
        self.dispatch = None
        _FakeJaxSession.made.append(self)

    def step_once(self):
        self.dispatch = self.dispatch or "parity"
        return _FakeMetrics()

    def enable_fast_path(self, n_inner):
        self.dispatch = "fast"

    def run_fast(self, n):
        return _FakeMetrics()


def _jax_gate(argv, monkeypatch, capsys) -> tuple[dict, object]:
    """The JAX package's scripts/e2e_quality.py on `argv`, on a fake
    session, mesher and renderer: (its JSON result, its session)."""
    import importlib.util
    import sys
    from pathlib import Path

    from catnerf_tpu import render_views as jrender
    from catnerf_tpu import utils as jutils
    from catnerf_tpu.data import synthetic as jsynthetic
    from catnerf_tpu.mesher import meshing as jmeshing
    from catnerf_tpu.train import loop as jloop

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "jax_e2e_gate", root / "scripts" / "e2e_quality.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    make_scene = jsynthetic.make_scene
    _FakeJaxSession.made = []
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(jsynthetic, "make_scene", lambda **kw: make_scene(
        **{**kw, "n_frames": 2, "width": 16, "height": 12}))
    monkeypatch.setattr(jloop, "TrainingSession", _FakeJaxSession)
    monkeypatch.setattr(jmeshing, "mesh_scene", lambda *a, **kw: {})
    monkeypatch.setattr(jrender, "scene_far", lambda sess: 1.0)
    monkeypatch.setattr(jrender, "render_scene_view", lambda sess, T, cam,
                        **kw: (np.zeros((16, 12, 3), np.float32), None,
                               None))
    monkeypatch.setattr(sys, "argv", ["e2e_quality.py", "--iters", "100",
                                      "--out", "unused", *argv])
    with pytest.raises(SystemExit):
        mod.main()
    result = json.loads(capsys.readouterr().out.splitlines()[-1])
    (sess,) = _FakeJaxSession.made
    return result, sess


def _config_items(cfg) -> dict:
    out = {}
    for k, v in vars(cfg).items():
        out[k] = _config_items(v) if hasattr(v, "__dict__") else v
    return out


MODE_ARGS = [
    [],
    ["--parity"],
    ["--strict-parity"],
    ["--strict-parity", "--flag", "seg_propagation_rounds=3", "--flag",
     "bf16_activations=1"],
    ["--strict-parity", "--dispatch", "fast"],
    ["--dispatch", "parity", "--shapes", "asym"],
    ["--flag", "mesh_method=tetra", "--flag", "eta1=0.05", "--flag",
     "mesh_space_carving=0", "--shapes", "mixed"],
]


@pytest.mark.parametrize("argv", MODE_ARGS, ids=lambda a: " ".join(a) or
                         "default")
def test_each_mode_resolves_the_jax_gates_config_and_sampling(
        argv, monkeypatch, capsys):
    """The port's gate parses the JAX gate's flags into the same Modes,
    and `resolve_modes` gives the Config the JAX gate trains (every
    attribute), its dispatch, and the result's
    `sampling`, `flag_overrides`, `dispatch_override` and `shapes`."""
    jresult, jsess = _jax_gate(argv, monkeypatch, capsys)
    seen = {}

    def fake_run(*args, **kw):
        seen.update(kw)
        return e2e.GateRun({"n_objects": 6, "n_meshed": 0,
                            "mean_accuracy_cm": None}, None, None, None)

    monkeypatch.setattr(e2e, "run", fake_run)
    monkeypatch.setattr(e2e, "passes", lambda result: False)
    assert e2e.main(["--device", "cpu", *argv]) == 1
    capsys.readouterr()
    modes = seen["modes"]
    cfg, parity, sampling = e2e.resolve_modes(modes, grid_dim=128)
    got, want = _config_items(cfg), _config_items(jsess.cfg)
    assert got == want
    assert ("parity" if parity else "fast") == jsess.dispatch
    assert sampling == jresult["sampling"]
    assert list(modes.flags) == jresult["flag_overrides"]
    assert modes.dispatch == jresult["dispatch_override"]
    assert modes.shapes == jresult["shapes"]


def test_an_unknown_flag_exits_as_the_jax_gate_does():
    with pytest.raises(SystemExit, match="Config has no attribute 'nope'"):
        e2e.resolve_modes(e2e.Modes(flags=("nope=1",)))


@pytest.mark.parametrize("shapes", ["asym", "mixed"])
def test_the_ground_truth_of_each_shape_is_the_jax_packages(shapes):
    """Every shape of an asym or mixed scene: the port's ground-truth
    mesh (`gt_shape_mesh`, marching cubes on the object-frame SDF) equals
    the JAX package's, vertices within 1e-12 and faces equal; the gate's
    session is built on that scene."""
    from catnerf_tpu.data.synthetic import make_scene as jmake_scene
    from catnerf_tpu.metrics.synthetic_eval import (
        gt_shape_mesh as jgt_shape_mesh)

    from catnerf_torch.metrics.synthetic_eval import gt_shape_mesh

    kw = dict(n_frames=2, width=16, height=12, n_categories=3,
              insts_per_cat=2, seed=0, shape_family=shapes)
    scene, jscene = e2e.make_scene(**kw), jmake_scene(**kw)
    assert [type(s).__name__ for s in scene.spheres] == [
        type(s).__name__ for s in jscene.spheres]
    assert len({type(s).__name__ for s in scene.spheres}) > 1
    for s, js in zip(scene.spheres, jscene.spheres):
        got, want = gt_shape_mesh(s), jgt_shape_mesh(js)
        np.testing.assert_allclose(got.vertices, want.vertices, rtol=0,
                                   atol=1e-12)
        np.testing.assert_array_equal(got.faces, want.faces)


def test_the_parity_dispatch_trains_step_once_in_chunks(monkeypatch):
    """--parity: one step_once a step on the epoch cursor's batches, no
    fast path, the prefetched batch released at the end."""
    _, sess = e2e.make_session(grid_dim=32, device="cpu")
    calls = []
    step_once = sess.step_once
    monkeypatch.setattr(sess, "step_once",
                        lambda: calls.append(1) or step_once())
    tr = e2e.train(sess, 3, parity=True)
    assert len(calls) == 3 and sess.iteration == 3
    assert sess._superstep is None and sess._prefetch_fut is None
    assert len(tr["psnr_hist"]) == 1


def test_a_split_category_exits_with_the_jax_gates_message():
    """The registered fit-holdout needs the held-out instance's category
    trained as registered; where registration split or dropped it, the
    gate exits with the JAX gate's message."""
    class Data:
        inst_dict = {0: {}, 181: {1: {}}}

    class Sess:
        cls_ids = [181]
        cfg = cam = None

    with pytest.raises(SystemExit, match="category 80 was split or dropped "
                       r"during registration \(trained ids \[0, 181\]\)"):
        e2e.run_fit_holdout(Sess(), None, (80, 3), data=Data(),
                            data_full=Data())


def test_the_registered_fit_holdout_runs_on_estimated_poses(tmp_path,
                                                            monkeypatch):
    """--registered --fit-holdout at a tiny size (one category of 3
    spheres in 4 frames of 64 x 48, a 20-step pretraining, 10 steps, a
    5-step fit): the held-out sphere is erased from the training layout
    (the loader never sees it), the full layout gives its cloud and
    frames, the templates are the trained spheres at their registered
    poses, and the result has the JAX gate's keys with path
    "registered"."""
    monkeypatch.setattr(e2e, "SCENE", dict(n_frames=4, width=64, height=48,
                                           n_categories=1, insts_per_cat=2))
    monkeypatch.setattr(e2e, "RENDER_BINS", 2)
    monkeypatch.setattr(e2e, "FIT_STEPS", 5)
    cfg, _, _ = e2e.resolve_modes(grid_dim=32)
    cfg.pretrain_steps, cfg.pretrain_rays = 20, 64
    cfg.multi_init_pose = False
    calls = []
    run_fit_holdout = e2e.run_fit_holdout

    def spy(sess, scene, held, **kw):
        calls.append(kw)
        return run_fit_holdout(sess, scene, held, **kw)

    monkeypatch.setattr(e2e, "run_fit_holdout", spy)
    run = e2e.run(10, 32, device="cpu", out=str(tmp_path), registered=True,
                  fit_holdout=True, cfg=cfg)
    result, sess = run.result, run.session
    held_cls, held = e2e.holdout(run.scene.inst_dict)
    assert result["metric"] == "e2e_synthetic_quality_registered"
    (kw,) = calls
    data, data_full = kw["data"], kw["data_full"]
    trained = {o for c, objs in data.inst_dict.items() if c for o in objs}
    assert held not in trained and trained == {1, 2}
    assert held in data_full.inst_dict[held_cls]
    assert not any((s["obj_mask"] == held).any()
                   for s in data.sample_dict.values())
    assert set(result["registration"]) == trained
    fh = result["fit_holdout"]
    assert set(fh) == FIT_HOLDOUT_KEYS
    assert fh["held_out"] == held and fh["path"] == "registered"
    assert fh["fit_steps"] == 5
    assert np.isfinite([fh["registration_chamfer"], fh["pose_center_err_cm"],
                        fh["psnr_prior_init"], fh["psnr_after_fit"]]).all()
    assert sorted(int(k) for k in result["per_object"]) == [1, 2]
