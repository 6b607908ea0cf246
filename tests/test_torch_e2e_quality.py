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


def test_the_registered_fit_holdout_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="item 4c"):
        e2e.run(registered=True, fit_holdout=True, device="cpu")


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
