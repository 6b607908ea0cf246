"""Per-object 3D evaluation CLI (a copy of the JAX package's
`metrics/eval_obj.py` on the port's mesher, boxes and metrics).

Parity target: `metric/eval_3D_obj.py` — for each scene and exported object
mesh, load the GT submesh (Replica habitat `mesh_semantic.ply_<id>.ply` /
ScanNet `<scene>_vh_clean_2.ply_<id>.ply`), sample surfaces (10k object /
200k background), compute accuracy (on the rec mesh cropped to the
reference OBB), completion, and completion ratio <5 cm, save per-object
.npy, print per-scene means. Supports comparing against another run's
meshes via --log_dir_ref.

It reads the meshes the training CLI exports,
`<log_dir>/<scene>/scene_mesh/iteration_<N>_obj<id>.obj` (`it_<N>_...`
too under --log_dir_ref, the vMAP runs the reference compared against),
and the dataset's GT layout: Replica's `habitat/mesh_semantic.ply_<id>.ply`
and `info_semantic.json`, ScanNet's `<scene>_vh_clean_2.ply_<id>.ply`,
`<scene>.aggregation.json` and `scannetv2-labels.combined.tsv`. Only
meshes: it runs on the host, no device.

Usage:
  python -m catnerf_torch.metrics.eval_obj --data_dir Datasets/Replica \
      --log_dir logs/Replica [--log_dir_ref other_logs] [--iteration 10000]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np

from catnerf_torch.data.scene import OrientedBBox
from catnerf_torch.geometry.obb import oriented_bounds
from catnerf_torch.mesher.mesh import TriMesh, load_mesh
from catnerf_torch.metrics import metrics3d

REPLICA_BG_CLS = [5, 12, 30, 31, 40, 60, 92, 93, 95, 97, 98, 79]
SCANNET_BG_CLS = [-1, 0, 1, 3, 16, 41, 232, 21, 161, 128, 21]
REPLICA_SCENES = ["room_0", "room_1", "room_2", "office_0", "office_1",
                  "office_2", "office_3", "office_4"]
SCANNET_SCENES = ["scene0013_02", "scene0059_00", "scene0066_00",
                  "scene0281_00"]


def concatenate_meshes(meshes: list[TriMesh]) -> TriMesh:
    verts, faces, offset = [], [], 0
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + offset)
        offset += len(m.vertices)
    return TriMesh(np.concatenate(verts), np.concatenate(faces))


def calc_3d_metric(mesh_rec: TriMesh, mesh_ref: TriMesh, n: int = 200000,
                   seed: int = 0):
    """(ref: metric/eval_3D_obj.py:10-39): accuracy on the OBB-cropped rec
    mesh; completion/ratio on the full rec mesh; x100 units.

    Reference-shaped wrapper over metrics3d.calc_3d_metric — ONE
    implementation of the crop/sample/metric protocol (a second copy here
    had already started to drift). Differences kept from the reference CLI:
    the OBB is derived from the GT mesh, and an empty crop aborts the
    object ('no mesh found') instead of falling back to the full mesh."""
    out = oriented_bounds(mesh_ref.vertices)
    obb = None
    crop = None
    if out is not None:
        T, extents = out
        obb = OrientedBBox(center=T[:3, 3], R=T[:3, :3], extent=extents)
        crop = mesh_rec.crop_to_obb(obb.center, obb.R, obb.extent)
        if len(crop.faces) == 0:
            print("no mesh found")
            return None
    d = metrics3d.calc_3d_metric(mesh_rec, mesh_ref, n_samples=n,
                                 ref_obb=obb, seed=seed, rec_crop=crop)
    return [[d["accuracy"]], [d["completion"]], [d["completion_ratio"]]]


def get_gt_bg_mesh(gt_dir: str, background_cls_list: list[int]) -> TriMesh:
    """(ref: metric/eval_3D_obj.py:41-53)."""
    with open(os.path.join(gt_dir, "info_semantic.json")) as f:
        label_obj_list = json.load(f)["objects"]
    meshes = []
    for obj in label_obj_list:
        if int(obj["class_id"]) in background_cls_list:
            p = os.path.join(gt_dir, f"mesh_semantic.ply_{int(obj['id'])}.ply")
            meshes.append(load_mesh(p))
    return concatenate_meshes(meshes)


def read_label_mapping(filename: str, label_from="raw_category",
                       label_to="id") -> dict:
    """(ref: metric/eval_3D_obj.py:75-85)."""
    mapping = {}
    with open(filename) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            mapping[row[label_from]] = int(row[label_to])
    return mapping


def get_gt_bg_mesh_scannet(gt_dir: str, exp: str, background_cls_list,
                           label_map_file: str) -> TriMesh:
    """(ref: metric/eval_3D_obj.py:55-73)."""
    label_map = read_label_mapping(label_map_file)
    with open(os.path.join(gt_dir, f"{exp}.aggregation.json")) as f:
        label_obj_list = json.load(f)["segGroups"]
    meshes = []
    for obj in label_obj_list:
        if label_map.get(obj["label"]) in background_cls_list:
            p = os.path.join(gt_dir,
                             f"{exp}_vh_clean_2.ply_{int(obj['id']) + 2}.ply")
            meshes.append(load_mesh(p))
    meshes.append(load_mesh(os.path.join(gt_dir, f"{exp}_vh_clean_2.ply_0.ply")))
    return concatenate_meshes(meshes)


def get_obj_ids(obj_dir: str) -> list[int]:
    """Parse object ids from exported mesh filenames
    (ref: metric/eval_3D_obj.py:95-103). A missing mesh dir (scene never
    trained/meshed) reads as 'no objects' so a multi-scene eval run keeps
    going instead of losing all completed scenes to FileNotFoundError."""
    if not os.path.isdir(obj_dir):
        return []
    obj_ids = []
    for f in os.listdir(obj_dir):
        if "obj" not in f:
            continue
        obj_id = f.split("obj")[1].rsplit(".", 1)[0]
        if obj_id in ("", "0"):
            continue
        obj_ids.append(int(obj_id))
    return sorted(set(obj_ids))


def eval_scene(data_dir: str, log_dir: str, exp: str, dataset: str,
               iteration: int, log_dir_ref: str = "",
               include_background: bool = True) -> np.ndarray | None:
    """Evaluate one scene; returns the (3, n_obj, 1) metric array."""
    gt_dir = os.path.join(data_dir, exp, "habitat")
    mesh_dir = os.path.join(log_dir, exp, "scene_mesh")
    mesh_dir_ref = os.path.join(log_dir_ref, exp, "scene_mesh") if log_dir_ref else ""
    output_path = os.path.join(log_dir, exp, "eval_mesh")
    os.makedirs(output_path, exist_ok=True)

    bg_cls = REPLICA_BG_CLS if dataset == "Replica" else SCANNET_BG_CLS
    label_map_file = os.path.join(data_dir, "scannetv2-labels.combined.tsv")

    metrics_3d = [[], [], []]
    obj_ids = get_obj_ids(mesh_dir)
    if include_background:
        obj_ids = [0] + obj_ids
    # nothing reconstructed for this scene: report instead of loading GT
    if not any(os.path.exists(os.path.join(
            mesh_dir, f"iteration_{iteration}_obj{o}.obj")) for o in obj_ids):
        return None
    for obj_id in obj_ids:
        if obj_id == 0:
            if not os.path.exists(os.path.join(
                    mesh_dir, f"iteration_{iteration}_obj0.obj")):
                continue
            n = 200000
            try:
                mesh_gt = (get_gt_bg_mesh(gt_dir, bg_cls)
                           if dataset == "Replica"
                           else get_gt_bg_mesh_scannet(gt_dir, exp, bg_cls,
                                                       label_map_file))
            except FileNotFoundError as e:
                # missing GT for one scene must not kill a multi-scene run
                print(f"missing GT for {exp} background: {e}")
                continue
        else:
            n = 10000
            p = (os.path.join(gt_dir, f"mesh_semantic.ply_{obj_id}.ply")
                 if dataset == "Replica"
                 else os.path.join(gt_dir, f"{exp}_vh_clean_2.ply_{obj_id}.ply"))
            if not os.path.exists(p):
                print(f"missing GT mesh {p}")
                continue
            mesh_gt = load_mesh(p)

        rec_file = os.path.join(mesh_dir, f"iteration_{iteration}_obj{obj_id}.obj")
        if not os.path.exists(rec_file):
            continue
        mesh_rec = load_mesh(rec_file)
        mesh_ref = mesh_gt
        if mesh_dir_ref:
            # this pipeline exports iteration_*; the reference CLI compared
            # against a vMAP run that wrote it_* (ref: metric/
            # eval_3D_obj.py:131-136) — accept both, and say so when
            # neither exists instead of silently comparing against GT
            for name in (f"iteration_{iteration}_obj{obj_id}.obj",
                         f"it_{iteration}_obj{obj_id}.obj"):
                cand = os.path.join(mesh_dir_ref, name)
                if os.path.exists(cand):
                    mesh_ref = load_mesh(cand)
                    break
            else:
                print(f"--log_dir_ref: no mesh for obj {obj_id} in "
                      f"{mesh_dir_ref}; comparing against GT")

        metrics = calc_3d_metric(mesh_rec, mesh_ref, n=n)
        if metrics is None:
            continue
        np.save(os.path.join(output_path, f"metric_obj{obj_id}.npy"),
                np.array(metrics))
        for k in range(3):
            metrics_3d[k].append(metrics[k])
    if not metrics_3d[0]:
        return None
    arr = np.array(metrics_3d)
    np.save(os.path.join(output_path, "metrics_3D_obj.npy"), arr)
    print("metrics 3D obj \n Acc | Comp | Comp Ratio 5cm \n", arr.mean(axis=1))
    return arr


def resolve_dataset_and_scenes(args) -> tuple[str, list[str]]:
    """Dataset detection + scene-list defaulting shared by the per-object
    and scene-aggregate CLIs (one place to grow when datasets are added)."""
    dataset = args.data_dir.rstrip("/").split("/")[-1]
    if dataset not in ("Replica", "ScanNet"):
        # the reference errors on unsupported datasets (metric/
        # eval_3D_obj.py); silently defaulting to ScanNet turned a
        # misspelled --data_dir into a confusing FileNotFoundError
        raise SystemExit(
            f"unsupported dataset {dataset!r}: --data_dir must end in "
            "'Replica' or 'ScanNet' (got " + args.data_dir + ")")
    scenes = args.scenes or (REPLICA_SCENES if dataset == "Replica"
                             else SCANNET_SCENES)
    return dataset, scenes


def parse_args(prog: str, argv=None):
    """The JAX package's arguments of both evaluation CLIs."""
    parser = argparse.ArgumentParser(prog=prog)
    parser.add_argument("--data_dir", default="Datasets/Replica")
    parser.add_argument("--log_dir", default="logs/Replica")
    parser.add_argument("--log_dir_ref", default="")
    parser.add_argument("--iteration", default=10000, type=int)
    parser.add_argument("--scenes", nargs="*", default=None)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args("python -m catnerf_torch.metrics.eval_obj", argv)
    dataset, scenes = resolve_dataset_and_scenes(args)
    for exp in scenes:
        eval_scene(args.data_dir, args.log_dir, exp, dataset, args.iteration,
                   args.log_dir_ref)
        print("-----------------------------------------")
        print("finished scene", exp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
