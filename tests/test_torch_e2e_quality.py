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
                                                           capsys):
    """10 steps and 32-voxel grids: no quality bound at that length, but
    the whole path runs and prints its one JSON line, with the exit code
    of the gate's pass rule."""
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
