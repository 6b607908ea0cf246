"""The port's evaluation CLIs (`catnerf_torch.metrics.eval_obj`,
`eval_scene`) against the JAX package's on the same GT layouts and
reconstructed meshes, on the CPU: the same numpy sampling streams and
the same C++ KD-tree, so the metrics agree bit for bit."""

from __future__ import annotations

import json
import shutil
import sys

import numpy as np
import pytest

from catnerf_torch.mesher.mesh import TriMesh
from catnerf_torch.metrics import eval_obj, eval_scene
from catnerf_torch.native.lib import geomlib

SCANNET_LABELS = "raw_category\tid\nwall\t1\nfloor\t2\nchair\t5\n"


def sphere_mesh(radius, center, n=16):
    t = np.linspace(-1.5 * radius, 1.5 * radius, n)
    X, Y, Z = np.meshgrid(t, t, t, indexing="ij")
    occ = 1 / (1 + np.exp((np.sqrt(X**2 + Y**2 + Z**2) - radius) * 30
                          / radius))
    v, f = geomlib.marching_cubes(occ.astype(np.float32), 0.5)
    v = v / (n - 1) * 3 * radius - 1.5 * radius + np.asarray(center)
    return TriMesh(v, f)


#: reconstructed objects: (radius, centre) of each exported mesh. Object 3
#: has no GT mesh; object 4's mesh lies outside its GT box (an empty crop)
REC = {1: (0.3, [1.01, 0, 0]), 2: (0.4, [-1, 0.01, 0]), 3: (0.2, [0, 1, 0]),
       4: (0.2, [0, -2.5, 0]), 0: (3.0, [0, 0, 0.02])}
GT = {1: (0.3, [1, 0, 0]), 2: (0.4, [-1, 0, 0]), 4: (0.2, [0, -1, 0])}


def write_layout(root, dataset: str, exp: str, iteration: int,
                 prefix: str = "iteration", background: bool = True) -> tuple:
    """A GT layout of `dataset` (Replica or ScanNet) for scene `exp`
    under root/<dataset>, and a training CLI's exports under root/logs
    (the background's too where `background`: 200,000 samples a mesh).
    Returns (data_dir, log_dir)."""
    data_dir = root / dataset
    gt_dir = data_dir / exp / "habitat"
    mesh_dir = root / "logs" / exp / "scene_mesh"
    gt_dir.mkdir(parents=True)
    mesh_dir.mkdir(parents=True, exist_ok=True)
    if dataset == "Replica":
        for oid, (r, c) in GT.items():
            sphere_mesh(r, c).export_ply(
                str(gt_dir / f"mesh_semantic.ply_{oid}.ply"))
        sphere_mesh(3.0, [0, 0, 0]).export_ply(
            str(gt_dir / "mesh_semantic.ply_9.ply"))
        with open(gt_dir / "info_semantic.json", "w") as f:
            json.dump({"objects": [{"id": 1, "class_id": 20},
                                   {"id": 2, "class_id": 20},
                                   {"id": 4, "class_id": 20},
                                   {"id": 9, "class_id": 93}]}, f)
    else:
        for oid, (r, c) in GT.items():
            sphere_mesh(r, c).export_ply(
                str(gt_dir / f"{exp}_vh_clean_2.ply_{oid}.ply"))
        # background: segGroup 7 (a wall, file id 7 + 2) and the _0 mesh
        sphere_mesh(3.0, [0, 0, 0]).export_ply(
            str(gt_dir / f"{exp}_vh_clean_2.ply_9.ply"))
        sphere_mesh(3.0, [0, 0, 0.01]).export_ply(
            str(gt_dir / f"{exp}_vh_clean_2.ply_0.ply"))
        with open(gt_dir / f"{exp}.aggregation.json", "w") as f:
            json.dump({"segGroups": [{"id": 7, "label": "wall"},
                                     {"id": 8, "label": "chair"}]}, f)
        (data_dir / "scannetv2-labels.combined.tsv").write_text(
            SCANNET_LABELS)
    for oid, (r, c) in REC.items():
        if oid == 0 and not background:
            continue
        sphere_mesh(r, c).export(
            str(mesh_dir / f"{prefix}_{iteration}_obj{oid}.obj"))
    return data_dir, root / "logs"


def _both(root, dataset, exp, iteration=100, ref_prefix=None,
          background=True):
    """eval_scene of each package on its own copy of one layout: the
    (port, JAX) arrays and the per-object .npy files each wrote."""
    from catnerf_tpu.metrics import eval_obj as jeval_obj

    data_dir, log_dir = write_layout(root / "a", dataset, exp, iteration,
                                     background=background)
    ref = ""
    if ref_prefix is not None:
        _, ref_logs = write_layout(root / "ref", dataset, exp, iteration,
                                   prefix=ref_prefix, background=background)
        ref = str(ref_logs)
    shutil.copytree(root / "a", root / "b")
    got = eval_obj.eval_scene(str(data_dir), str(log_dir), exp, dataset,
                              iteration, ref)
    jdata = str(data_dir).replace(str(root / "a"), str(root / "b"))
    jlogs = str(log_dir).replace(str(root / "a"), str(root / "b"))
    want = jeval_obj.eval_scene(jdata, jlogs, exp, dataset, iteration, ref)
    files = {}
    for side, logs in (("port", log_dir), ("jax", jlogs)):
        out = sorted((root / logs / exp / "eval_mesh").glob("*.npy"))
        files[side] = {p.name: np.load(p) for p in out}
    return got, want, files


@pytest.mark.parametrize("dataset", ["Replica", "ScanNet"])
def test_eval_scene_is_the_jax_packages_bitwise(tmp_path, capsys, dataset):
    """Objects 1 and 2 and the background scored, object 3 (no GT mesh)
    and object 4 (an empty crop) skipped, as the JAX package does: the
    same (3, 3, 1) array and the same .npy files, bit for bit."""
    exp = "room_0" if dataset == "Replica" else "scene0013_02"
    got, want, files = _both(tmp_path, dataset, exp)
    assert got.shape == (3, 3, 1)
    np.testing.assert_array_equal(got, want)
    assert files["port"].keys() == files["jax"].keys() == {
        "metric_obj0.npy", "metric_obj1.npy", "metric_obj2.npy",
        "metrics_3D_obj.npy"}
    for k in files["port"]:
        np.testing.assert_array_equal(files["port"][k], files["jax"][k])
    out = capsys.readouterr().out
    assert out.count("missing GT mesh") == 2  # object 3, in each package
    assert out.count("no mesh found") == 2    # object 4's empty crop
    acc, comp, ratio = got[0].mean(), got[1].mean(), got[2].mean()
    assert acc < 5.0 and comp < 5.0 and ratio > 90.0


def test_log_dir_ref_reads_the_references_it_meshes(tmp_path, capsys):
    """--log_dir_ref against a run whose exports are named it_<N>_...:
    each object with a GT mesh is compared with the reference run's mesh
    (object 4 now too: its crop is the reference mesh's box), as in the
    JAX package."""
    got, want, _ = _both(tmp_path, "Replica", "room_0", ref_prefix="it",
                         background=False)
    assert got.shape == (3, 3, 1)
    np.testing.assert_array_equal(got, want)
    assert "comparing against GT" not in capsys.readouterr().out


def test_a_scene_with_no_meshes_returns_none(tmp_path):
    from catnerf_tpu.metrics import eval_obj as jeval_obj

    for mod in (eval_obj, jeval_obj):
        assert mod.eval_scene(str(tmp_path / "Replica"),
                              str(tmp_path / "logs"), "room_1", "Replica",
                              100) is None


def _run_main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    rc = module.main()
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("cli", ["eval_scene", "eval_obj"])
def test_the_clis_print_and_save_what_the_jax_packages_do(
        tmp_path, capsys, monkeypatch, cli):
    """`python -m catnerf_torch.metrics.<cli>` with the JAX package's
    arguments over two scenes, one never meshed: the same printed tables
    and, for eval_scene, the same eval_3D_scene.json."""
    from catnerf_tpu.metrics import eval_obj as jeval_obj
    from catnerf_tpu.metrics import eval_scene as jeval_scene

    write_layout(tmp_path / "a", "Replica", "room_0", 100, background=False)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    argv = ["--data_dir", "{}/Replica", "--log_dir", "{}/logs",
            "--iteration", "100", "--scenes", "room_0", "office_0"]
    port = {"eval_scene": eval_scene, "eval_obj": eval_obj}[cli]
    jax = {"eval_scene": jeval_scene, "eval_obj": jeval_obj}[cli]
    rc = port.main([a.format(tmp_path / "a") for a in argv])
    out = capsys.readouterr().out
    jrc, jout = _run_main(jax, [a.format(tmp_path / "b") for a in argv],
                          monkeypatch, capsys)
    assert rc == 0 and jrc is None
    assert out == jout.replace(str(tmp_path / "b"), str(tmp_path / "a"))
    if cli == "eval_scene":
        assert "scene office_0: no meshes evaluated" in out
        got = json.loads((tmp_path / "a" / "logs" /
                          "eval_3D_scene.json").read_text())
        want = json.loads((tmp_path / "b" / "logs" /
                           "eval_3D_scene.json").read_text())
        assert got == want and got["scenes"]["room_0"]["n_objects"] == 2


def test_an_unsupported_data_dir_exits(tmp_path):
    with pytest.raises(SystemExit, match="unsupported dataset 'Other'"):
        eval_obj.main(["--data_dir", str(tmp_path / "Other")])
