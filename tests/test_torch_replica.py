"""The port's Replica loader (`catnerf_torch/data/replica.py`) against the
JAX package's, on the on-disk fixture of tests/test_replica_fixture.py
(96 x 72, 6 frames, 2 x 2 spheres, seed 1; PNGs written by OpenCV):
frames, instance lists and class remaps bitwise, keyframe stride 2, and
the registration cache: one the JAX package's loader writes loads in the
port without importing jax or the JAX package, and the port reads back
its own."""

from __future__ import annotations

import inspect
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from catnerf_torch.config import Config
from catnerf_torch.data import replica as treplica
from catnerf_torch.data.scene import OrientedBBox
from catnerf_torch.geometry import obb as tobb
from catnerf_torch.geometry import registration as treg
from catnerf_tpu.config import Config as JConfig
from catnerf_tpu.data import replica as jreplica
from catnerf_tpu.data.synthetic import make_scene
from catnerf_tpu.geometry import obb as jobb
from catnerf_tpu.geometry import registration as jreg

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_replica_fixture import write_replica_layout  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = dict(n_frames=6, width=96, height=72, n_categories=2,
               insts_per_cat=2, seed=1)
FORBIDDEN = ("jax", "jaxlib", "catnerf_tpu", "optax", "flax", "cv2", "PIL")


def _configure(cfg, root, **over):
    scene_cam = _scene().cam
    cfg.dataset_dir = str(root)
    cfg.width, cfg.height = FIXTURE["width"], FIXTURE["height"]
    cfg.fx = cfg.fy = scene_cam.fx
    cfg.cx, cfg.cy = scene_cam.cx, scene_cam.cy
    cfg.depth_scale = 1.0 / 1000.0
    cfg.load_pretrained = False
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


_SCENE = []


def _scene():
    if not _SCENE:
        _SCENE.append(make_scene(**FIXTURE))
    return _SCENE[0]


def _layout(root: Path) -> Path:
    write_replica_layout(_scene(), str(root), 1.0 / 1000.0)
    return root


def _assert_frames_equal(tdata, jdata):
    assert sorted(tdata.sample_dict) == sorted(jdata.sample_dict)
    assert tdata.frame_ids == jdata.frame_ids
    for idx, js in jdata.sample_dict.items():
        ts = tdata.sample_dict[idx]
        assert ts.keys() == js.keys()
        for k in ("image", "depth", "obj_mask", "T"):
            assert ts[k].dtype == js[k].dtype, k
            np.testing.assert_array_equal(ts[k], js[k])
        assert ts["frame_id"] == js["frame_id"]
    assert sorted(tdata.inst_dict) == sorted(jdata.inst_dict)
    for cls_id, jinst in jdata.inst_dict.items():
        tinst = tdata.inst_dict[cls_id]
        if cls_id == 0:
            tinst, jinst = {0: tinst}, {0: jinst}
        assert sorted(tinst) == sorted(jinst)
        for obj_id, jinfo in jinst.items():
            tfi, jfi = tinst[obj_id]["frame_info"], jinfo["frame_info"]
            assert [f["frame"] for f in tfi] == [f["frame"] for f in jfi]
            for a, b in zip(tfi, jfi):
                np.testing.assert_array_equal(a["bbox"], b["bbox"])


@pytest.mark.parametrize("stride", [1, 2])
def test_frames_and_instances_match_jax(tmp_path, stride):
    """Replica(cfg, run_registration=False) of both packages on the
    fixture: every frame's arrays, the kept frames (every second one at
    frame_stride 2) and each instance's frame list and 2D boxes, bitwise."""
    _layout(tmp_path)
    over = dict(frame_stride=stride, load_registration_result=False)
    jdata = jreplica.Replica(_configure(JConfig(), tmp_path, **over),
                             run_registration=False)
    tdata = treplica.Replica(_configure(Config(), tmp_path, **over),
                             run_registration=False)
    assert len(tdata) == 6 // stride
    _assert_frames_equal(tdata, jdata)


def test_class_remaps_match_jax(tmp_path):
    """An instance of the undefined class 0 becomes the pseudo-class
    inst_id + 1000, one of a background class is dropped; both as the JAX
    package's loader does."""
    _layout(tmp_path)
    spheres = _scene().spheres
    undefined, background = spheres[0].inst_id, spheres[3].inst_id
    for idx in range(FIXTURE["n_frames"]):
        inst = cv2.imread(str(tmp_path / "semantic_instance"
                              / f"semantic_instance_{idx}.png"),
                          cv2.IMREAD_UNCHANGED)
        path = str(tmp_path / "semantic_class" / f"semantic_class_{idx}.png")
        cls = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        cls[inst == undefined] = 0
        cls[inst == background] = 40
        cv2.imwrite(path, cls)
    over = dict(load_registration_result=False)
    jdata = jreplica.Replica(_configure(JConfig(), tmp_path, **over),
                             run_registration=False)
    tdata = treplica.Replica(_configure(Config(), tmp_path, **over),
                             run_registration=False)
    assert undefined + treplica.CLS_ID_UNDEFINED in tdata.inst_dict
    assert all(background not in v for k, v in tdata.inst_dict.items()
               if k != 0)
    _assert_frames_equal(tdata, jdata)


def _gt_registration(inst_dict, sample_dict, cam, reg, obb):
    """Stands in for run_registration in the cache tests: stage 1, then
    each instance at its ground-truth pose with its box (get_obb)."""
    reg.get_all_poses(inst_dict, sample_dict, cam)
    inst_dict[0]["bbox3D"] = obb.get_bound(inst_dict[0]["pcs"])
    gt = {s.inst_id: s.gt_T_obj() for s in _scene().spheres}
    for cls_id, objs in inst_dict.items():
        if cls_id == 0:
            continue
        for obj_id, info in objs.items():
            info["T_obj"] = np.array(gt[obj_id])
            obb.get_obb(info)


def _cache_contents(inst_dict) -> dict:
    out = {}
    for cls_id, objs in inst_dict.items():
        items = {0: objs} if cls_id == 0 else objs
        for obj_id, info in items.items():
            b = info["bbox3D"]
            out[f"{cls_id}/{obj_id}"] = {
                "T_obj": None if cls_id == 0 else np.asarray(
                    info["T_obj"]).tolist(),
                "bbox": [np.asarray(b.center).tolist(),
                         np.asarray(b.R).tolist(),
                         np.asarray(b.extent).tolist()],
                "type": f"{type(b).__module__}.{type(b).__name__}"}
    return out


def test_a_cache_the_jax_package_wrote_loads_without_jax(tmp_path,
                                                         monkeypatch):
    """The JAX package's loader writes inst_dict.pkl (its OrientedBBox
    pickled by name); the port's loader, in a fresh interpreter, reads
    it through the tolerant reader into its own OrientedBBox, bitwise,
    and has then loaded neither jax, nor the JAX package, nor cv2 or
    PIL."""
    _layout(tmp_path)
    jcfg = _configure(JConfig(), tmp_path)
    monkeypatch.setattr(
        jreg, "run_registration",
        lambda i, s, c, cfg, name: _gt_registration(i, s, c, jreg, jobb))
    jreplica.Replica(jcfg)
    cache = tmp_path / "inst_dict.pkl"
    assert b"catnerf_tpu.data.scene" in cache.read_bytes()
    with open(cache, "rb") as f:
        want = _cache_contents(pickle.load(f))
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from catnerf_torch.config import Config\n"
        "from catnerf_torch.data.replica import Replica\n"
        f"cfg = Config.from_json({json.dumps(str(tmp_path / 'cfg.json'))})\n"
        "data = Replica(cfg, device='cpu')\n"
        + inspect.getsource(_cache_contents) +
        "print(json.dumps([_cache_contents(data.inst_dict), "
        "sorted(sys.modules)]))\n")
    _write_config(tmp_path / "cfg.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    got, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if m.split(".")[0] in FORBIDDEN] == []
    want = {k: dict(v, type="catnerf_torch.data.scene.OrientedBBox")
            for k, v in want.items()}
    assert got == want


def _write_config(path: Path, root: Path) -> None:
    """The fixture's camera and layout as a reference-schema config."""
    cam = _scene().cam
    with open(ROOT / "configs" / "Replica" /
              "config_replica_room0.json") as f:
        raw = json.load(f)
    raw["dataset"]["path"] = str(root)
    raw["camera"] = {"w": FIXTURE["width"], "h": FIXTURE["height"],
                     "fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy,
                     "mw": 0, "mh": 0}
    raw.setdefault("registration", {})["load_pretrained"] = False
    with open(path, "w") as f:
        json.dump(raw, f)


def test_the_port_reads_back_its_own_cache(tmp_path, monkeypatch):
    """The port's loader registers (here a stand-in stage), drops the
    point clouds and writes inst_dict.pkl; a second loader reads it
    instead of registering, bitwise."""
    _layout(tmp_path)
    calls = []

    def fake(i, s, c, cfg, name, device):
        calls.append(device)
        _gt_registration(i, s, c, treg, tobb)

    monkeypatch.setattr(treg, "run_registration", fake)
    first = treplica.Replica(_configure(Config(), tmp_path), device="cpu")
    assert calls == ["cpu"]
    assert all("pcs" not in info for c, objs in first.inst_dict.items()
               if c for info in objs.values())
    second = treplica.Replica(_configure(Config(), tmp_path), device="cpu")
    assert calls == ["cpu"]
    assert second.template_counts is None
    assert _cache_contents(second.inst_dict) == \
        _cache_contents(first.inst_dict)
    assert isinstance(second.inst_dict[0]["bbox3D"], OrientedBBox)
