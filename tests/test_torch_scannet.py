"""The port's ScanNet loader (`catnerf_torch/data/scannet.py`) against the
JAX package's, on the on-disk fixture of tests/test_scannet_fixture.py
(96 x 72, 5 frames, 2 x 2 spheres, seed 2; JPEGs and PNGs written by
OpenCV), with the middle frame's pose inf and a 2-pixel edge crop: frames,
masks, bounding boxes and per-object clouds bitwise, with the mask
refinement on and off, its unknown pixels on and off, and keyframe stride
2; the refined-mask caches each package writes, read by the other; the
missing-intrinsics raise; registration stage 1's TSDF route bitwise and
the whole registration on the coverage route within 1e-9; and the port's
own layout writer read back by the JAX package's loader."""

from __future__ import annotations

import copy
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from catnerf_torch.config import Config
from catnerf_torch.data import scannet as tscannet
from catnerf_torch.geometry import field_pretrain as tfp
from catnerf_torch.geometry import registration as treg
from catnerf_tpu.config import Config as JConfig
from catnerf_tpu.data import scannet as jscannet
from catnerf_tpu.data.synthetic import make_scene
from catnerf_tpu.geometry import field_pretrain as jfp
from catnerf_tpu.geometry import registration as jreg

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_scannet_fixture import CLS_OFFSET, write_scannet_layout  # noqa

torch.set_num_threads(1)

FIXTURE = dict(n_frames=5, width=96, height=72, n_categories=2,
               insts_per_cat=2, seed=2)
HOST_TOL = 1e-9


def _scene():
    return make_scene(**FIXTURE)


def _configure(cfg, root, **over):
    cam = _scene().cam
    cfg.dataset_format = "ScanNet"
    cfg.dataset_dir = str(root)
    cfg.width, cfg.height = FIXTURE["width"], FIXTURE["height"]
    cfg.fx = cfg.fy = cam.fx
    cfg.cx, cfg.cy = cam.cx, cam.cy
    cfg.mw = cfg.mh = 2
    cfg.depth_scale = 1.0 / 1000.0
    cfg.load_pretrained = False
    cfg.load_registration_result = False
    cfg.multi_init_pose = False
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _with_inf_pose(root):
    frames = sorted(_scene().sample_dict)
    np.savetxt(root / "pose" / f"{frames[len(frames) // 2]}.txt",
               np.full((4, 4), np.inf))


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """The fixture's layout, written by OpenCV, pristine (each test works
    on a copy, since the loaders write their caches into it)."""
    root = tmp_path_factory.mktemp("scannet")
    write_scannet_layout(_scene(), str(root), 1.0 / 1000.0)
    _with_inf_pose(root)
    return root


def _copy(layout, dst):
    shutil.copytree(layout, dst)
    return dst


def _assert_loaded_alike(t, j):
    assert t.n_img == j.n_img
    assert sorted(t.sample_dict) == sorted(j.sample_dict)
    for k, js in j.sample_dict.items():
        ts = t.sample_dict[k]
        assert ts["frame_id"] == js["frame_id"]
        for key in ("image", "depth", "obj_mask", "T"):
            assert ts[key].dtype == js[key].dtype, key
            np.testing.assert_array_equal(ts[key], js[key], err_msg=key)
    assert sorted(t.inst_dict) == sorted(j.inst_dict)
    for c, jobjs in j.inst_dict.items():
        tobjs = t.inst_dict[c]
        if c == 0:
            jobjs = {0: jobjs}
            tobjs = {0: tobjs}
        assert sorted(tobjs) == sorted(jobjs)
        for o, jinfo in jobjs.items():
            tinfo = tobjs[o]
            assert sorted(tinfo) == sorted(jinfo)
            for tf, jf in zip(tinfo["frame_info"], jinfo["frame_info"],
                              strict=True):
                assert tf["frame"] == jf["frame"]
                np.testing.assert_array_equal(tf["bbox"], jf["bbox"])
            if "pcs" in jinfo:
                np.testing.assert_array_equal(tinfo["pcs"], jinfo["pcs"])


CASES = [
    dict(use_refined_mask=False),
    dict(use_refined_mask=True),
    dict(use_refined_mask=True, refined_mask_unknown=False),
    dict(use_refined_mask=True, frame_stride=2),
]


@pytest.mark.parametrize("over", CASES, ids=[
    "raw", "refined", "refined-no-unknown", "refined-stride2"])
def test_the_loaders_agree_bitwise(layout, tmp_path, over):
    jroot = _copy(layout, tmp_path / "jax")
    troot = _copy(layout, tmp_path / "port")
    j = jscannet.ScanNet(_configure(JConfig(), jroot, **over),
                         run_registration=False)
    t = tscannet.ScanNet(_configure(Config(), troot, **over),
                         run_registration=False, device="cpu")
    _assert_loaded_alike(t, j)
    assert t.n_img == len(range(0, FIXTURE["n_frames"],
                                over.get("frame_stride", 1))) - 1
    if over.get("use_refined_mask"):
        # the same cache files, byte for byte where numpy wrote them
        for sub in ("instance-refined", "instance-disputed"):
            names = sorted(p.name for p in (jroot / sub).iterdir())
            assert names == sorted(p.name for p in (troot / sub).iterdir())
            for name in names:
                np.testing.assert_array_equal(np.load(troot / sub / name),
                                              np.load(jroot / sub / name))
        assert sorted(p.name for p in (jroot / "inst_to_cls").iterdir()) \
            == sorted(p.name for p in (troot / "inst_to_cls").iterdir())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_refined_caches_read_in_the_other_package(layout, tmp_path, writer):
    """The refined-mask caches one package writes (use_refined_mask), read
    by the other (load_refined_mask), give what the writer's own reread
    gives, bitwise."""
    root = _copy(layout, tmp_path / "layout")
    make = {"jax": lambda cfg: jscannet.ScanNet(cfg, run_registration=False),
            "port": lambda cfg: tscannet.ScanNet(cfg, run_registration=False,
                                                 device="cpu")}
    conf = {"jax": JConfig, "port": Config}
    make[writer](_configure(conf[writer](), root, use_refined_mask=True))
    reader = "port" if writer == "jax" else "jax"
    again = {name: make[name](_configure(conf[name](), root,
                                         use_refined_mask=True,
                                         load_refined_mask=True))
             for name in (writer, reader)}
    _assert_loaded_alike(again["port"], again["jax"])


def test_missing_intrinsics_raise_in_both(layout, tmp_path):
    root = _copy(layout, tmp_path / "layout")
    (root / "intrinsic" / "intrinsic_depth.txt").unlink()
    for cfg, loader in ((JConfig(), jscannet.ScanNet),
                        (Config(), tscannet.ScanNet)):
        with pytest.raises(FileNotFoundError, match="refusing to run with "
                           "default intrinsics"):
            loader(_configure(cfg, root), run_registration=False)


@pytest.fixture(scope="module")
def loaded(layout, tmp_path_factory):
    """Both loaders on a copy of the layout with the mask refinement (no
    registration)."""
    base = tmp_path_factory.mktemp("loaded")
    j = jscannet.ScanNet(_configure(JConfig(), _copy(layout, base / "j"),
                                    use_refined_mask=True),
                         run_registration=False)
    t = tscannet.ScanNet(_configure(Config(), _copy(layout, base / "t"),
                                    use_refined_mask=True),
                         run_registration=False, device="cpu")
    return j, t


def test_stage1_tsdf_route_is_bitwise(loaded):
    """get_all_poses(name="scannet"): the background fused through TSDF,
    the instances' loader clouds voxel-downsampled, bitwise."""
    j, t = loaded
    jinst, tinst = copy.deepcopy(j.inst_dict), copy.deepcopy(t.inst_dict)
    jreg.get_all_poses(jinst, j.sample_dict, j.cam, name="scannet",
                       max_depth=j.cfg.max_depth, want_color=True)
    treg.get_all_poses(tinst, t.sample_dict, t.cam, name="scannet",
                       max_depth=t.cfg.max_depth, want_color=True)
    assert len(jinst[0]["pcs"]) > 100
    np.testing.assert_array_equal(tinst[0]["pcs"], jinst[0]["pcs"])
    for k in ("center", "R", "extent"):
        np.testing.assert_array_equal(getattr(tinst[0]["bbox3D"], k),
                                      getattr(jinst[0]["bbox3D"], k))
    for c, objs in jinst.items():
        if c == 0:
            continue
        for o, info in objs.items():
            np.testing.assert_array_equal(tinst[c][o]["pcs"], info["pcs"])
            np.testing.assert_array_equal(tinst[c][o]["pcs_rgb"],
                                          info["pcs_rgb"])


def test_missing_instance_takes_the_identity(loaded):
    """An instance with frames but no cloud (missing from the refined
    segmentation) gets T_obj = I and no cloud, as in the JAX package."""
    j, t = loaded
    out = []
    for reg, data in ((jreg, j), (treg, t)):
        inst = copy.deepcopy(data.inst_dict)
        c = sorted(k for k in inst if k)[0]
        o = sorted(inst[c])[0]
        inst[c][o].pop("pcs", None)
        reg.get_all_poses(inst, data.sample_dict, data.cam, name="scannet")
        out.append(inst[c][o])
    for info in out:
        assert info["pcs"] is None
        np.testing.assert_array_equal(info["T_obj"], np.eye(4))


def test_registration_on_the_scannet_coverage_route(loaded, monkeypatch):
    """The whole run_registration(name="scannet") of both packages with
    no field pretrained (the geometric coverage score about the clouds'
    mean): the same template scores, and T_obj and boxes within 1e-9."""
    for mod in (tfp, jfp):
        monkeypatch.setattr(mod, "pretrain_object_fields",
                            lambda objects, *a, **k: [None] * len(objects))
    j, t = loaded
    jinst, tinst = copy.deepcopy(j.inst_dict), copy.deepcopy(t.inst_dict)
    jreg.run_registration(jinst, j.sample_dict, j.cam, j.cfg, name="scannet")
    counts = treg.run_registration(tinst, t.sample_dict, t.cam, t.cfg,
                                   name="scannet", device="cpu")
    assert counts and all(counts.values())
    assert sorted(tinst) == sorted(jinst)
    for c, jobjs in jinst.items():
        if c == 0:
            continue
        assert sorted(tinst[c]) == sorted(jobjs)
        for o, jinfo in jobjs.items():
            tinfo = tinst[c][o]
            np.testing.assert_allclose(tinfo["T_obj"], jinfo["T_obj"],
                                       rtol=0, atol=HOST_TOL)
            for k in ("center", "R", "extent"):
                np.testing.assert_allclose(
                    getattr(tinfo["bbox3D"], k), getattr(jinfo["bbox3D"], k),
                    rtol=0, atol=HOST_TOL)


def test_the_ports_layout_reads_in_the_jax_loader(tmp_path):
    """`data/scannet.write_scannet_layout` (the port's JPEG and PNG
    writers) read back by the JAX package's loader (OpenCV) and the
    port's, bitwise; its class ids are the fixture's."""
    scene = _scene()
    root = tmp_path / "layout"
    tscannet.write_scannet_layout(scene, str(root), 1.0 / 1000.0)
    _with_inf_pose(root)
    assert tscannet.LAYOUT_CLS_OFFSET == CLS_OFFSET
    j = jscannet.ScanNet(_configure(JConfig(), root), run_registration=False)
    t = tscannet.ScanNet(_configure(Config(), root), run_registration=False,
                         device="cpu")
    _assert_loaded_alike(t, j)
    want = sorted({sp.cls_id + CLS_OFFSET for sp in scene.spheres})
    assert sorted(c for c in t.inst_dict if c) == want


def test_the_layout_writes_larger_colour(tmp_path):
    """color_size writes the colour larger than the depth (a real
    sequence's 1296 x 968 beside 640 x 480); the loader resizes it back,
    as the JAX package's does."""
    scene = make_scene(n_frames=1, width=64, height=48, n_categories=1,
                       insts_per_cat=1, seed=0)
    root = tmp_path / "layout"
    tscannet.write_scannet_layout(scene, str(root), 1.0 / 1000.0,
                                  color_size=(130, 97))
    from catnerf_torch.data import jpeg

    assert jpeg.imread(str(root / "color" / "0.jpg")).shape == (97, 130, 3)
    over = dict(width=64, height=48, mw=0, mh=0)
    j = jscannet.ScanNet(_configure(JConfig(), root, **over),
                         run_registration=False)
    t = tscannet.ScanNet(_configure(Config(), root, **over),
                         run_registration=False, device="cpu")
    _assert_loaded_alike(t, j)
    assert t.sample_dict[0]["image"].shape == (64, 48, 3)
