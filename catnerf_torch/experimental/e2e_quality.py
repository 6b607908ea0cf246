"""End-to-end quality gate: train the synthetic scene, mesh every
object, and score the meshes against the analytic ground truth.

The port of the JAX package's `scripts/e2e_quality.py`, in all its modes:
- default: ground-truth object poses, the fast path;
- `--registered` (ref: scripts/e2e_quality.py:178-247): the scene is
  written in the Replica layout (`data/replica.write_replica_layout`) and
  loaded through the real pipeline, `Replica(cfg)` with `load_pretrained
  = False` — point-cloud accumulation, self-pretrained uncertainty fields
  on the device, TEASER-style multi-init alignment, subcategorization —
  so training uses ESTIMATED object poses; mesh errors then include any
  pose misalignment;
- `--fit-holdout` (ref: :69-77, 159-172, 319-410): 3 instances a
  category, the first category's last held out of training, then
  registered to its category's canonical union, fitted against the
  frozen MLP (`fit.py`, 1,000 steps with pose refinement), meshed and
  scored by the same protocol; with `--registered` (:187-250, 327-374)
  the held-out instance is erased from the training layout's masks, a
  second, full layout (`Replica(cfg_full, run_registration=False)`)
  gives its loader-grade cloud and frames, and the templates are the
  trained instances' loader-grade clouds at their ESTIMATED poses;
- `--registered --dataset scannet` (ref: :216-247): the scene is written
  in the ScanNet layout instead (`data/scannet.write_scannet_layout`:
  JPEG colour, 16-bit PNG depth and masks, one pose file a frame), the
  last frame's pose set to inf (the loader skips it), and loaded by
  `ScanNet(cfg)` with a 4-pixel edge crop and, unless `--no-refined-mask`,
  the geometric-segmentation mask refinement (its image stages on the
  device); its point clouds come from TSDF fusion. The loader shifts
  instance ids by +1 and the layout's class ids are the scene's + 50, so
  the scored targets are remapped alike;
- `--shapes sphere|asym|mixed`: the scene's shape families
  (`make_scene(shape_family=)`), each scored against its analytic surface
  (`metrics/synthetic_eval.gt_shape_mesh`, marching cubes on the
  object-frame SDF);
- `--strict-parity`, `--parity`, `--flag NAME=VALUE` and `--dispatch
  parity|fast`, resolved as :136-155 (`resolve_modes`): the strict-parity
  flag set, then each override (bools as 0/1), then the dispatch;
  parity dispatch trains `step_once` x 100 a chunk on the epoch cursor's
  batches, fast dispatch `run_fast(100)` (:259-282).
The scene is 3 categories x 2 shapes in 24 frames of 160x120
(`make_scene`, seeded by --seed); the trainer is `Config()` with
latent_dim 32 (the reference's default: bf16 activation storage on the XLA
path; on a CUDA session each fast step a replayed CUDA graph); meshes come
from `mesh_scene` at most `--grid-dim` voxels a side, and each shape is
scored by `score_shape` under the reference's protocol (accuracy on the
mesh cropped to the GT box, completion, completion ratio under 5 cm; ref:
metric/eval_3D_obj.py:15-34); then the scene composite from two dataset
poses against their frames (`render_psnr`, dB). Prints one JSON line;
exits 1 when an object was not meshed or a mean is outside the gate's
band (accuracy and completion under 5 cm, completion ratio over 80%), or,
with --fit-holdout, when the fitted mesh is missing or 5 cm or more in
accuracy, or the fit did not raise the PSNR.

    python -m catnerf_torch.experimental.e2e_quality            # the card
    python -m catnerf_torch.experimental.e2e_quality --device cpu \\
        --iters 100 --grid-dim 32
    python -m catnerf_torch.experimental.e2e_quality --registered \\
        --fit-holdout
    python -m catnerf_torch.experimental.e2e_quality --strict-parity \\
        --flag seg_propagation_rounds=3 --dispatch fast --shapes asym

Also the flip rule that holds a uint8 occupancy grid evaluated on two
devices (or by two packages) against each other (`count_flips`,
`carve_boundary`): float32 sums in another order may put a value on the
other side of a rounding boundary, and only there may two grids differ.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from catnerf_torch.config import Config
from catnerf_torch.data.replica import Replica, write_replica_layout
from catnerf_torch.data.scannet import (LAYOUT_CLS_OFFSET, ScanNet,
                                        write_scannet_layout)
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.mesher.mesh import load_mesh
from catnerf_torch.mesher.meshing import (mesh_scene, mesh_timings,
                                          reset_mesh_timings)
from catnerf_torch.metrics.synthetic_eval import score_shape
from catnerf_torch.native.lib import geomlib
from catnerf_torch.train.loop import TrainingSession
from catnerf_torch.utils import phase_reset, phase_timings

SCENE = dict(n_frames=24, width=160, height=120, n_categories=3,
             insts_per_cat=2)
# --fit-holdout: 3 instances a category, so that the held-out one's
# category stays multi-instance, and the JAX gate's fit length
HOLDOUT_INSTS = 3
FIT_STEPS = 1000
CHUNK_STEPS = 100
# the image-space readout (ref: scripts/e2e_quality.py:303-317): the scene
# composite from the first and the middle frame, at the frames' camera
RENDER_NEAR = 0.1
RENDER_BINS = 64

# the flip rule: a uint8 voxel may differ by one quantum where occ * 255
# lies within FLIP_U8 (255 x the float32 bound 1e-5) of a .5 boundary; a
# carve bit where a projected pixel coordinate lies within FLIP_PIXEL of a
# .5 boundary (or of an image edge) or the depth test within FLIP_DEPTH of
# its margin; at most FLIP_SHARE of the voxels in all
FLIP_U8 = 2.6e-3
FLIP_PIXEL = 1e-4
FLIP_DEPTH = 1e-5
FLIP_SHARE = 1e-3


class Modes(NamedTuple):
    """The JAX gate's mode flags (ref: scripts/e2e_quality.py:36-90)."""
    strict_parity: bool = False
    parity: bool = False
    flags: tuple = ()         # "NAME=VALUE", applied after strict_parity
    dispatch: str | None = None   # "parity" or "fast": overrides the two
    shapes: str = "sphere"


def resolve_modes(modes: Modes = Modes(), grid_dim: int = 128):
    """(cfg, parity, sampling) as the JAX gate resolves its flags (ref:
    scripts/e2e_quality.py:136-155, 429-433): `Config()` with latent_dim
    32 and `grid_dim`; --strict-parity applies the strict-parity flag set
    and implies parity dispatch; each --flag sets a Config attribute of
    the type it has (bools as 0/1); --dispatch then sets the dispatch.
    sampling: "strict-parity" under --strict-parity, else the dispatch
    ("parity" or "fast")."""
    cfg = Config()
    cfg.net_hyperparams.latent_dim = 32
    cfg.grid_dim = grid_dim  # live_voxel_size stays 5 mm; the cap rules
    parity = modes.parity
    if modes.strict_parity:
        cfg.apply_strict_parity()
        parity = True
    for ov in modes.flags:
        name, _, val = ov.partition("=")
        if not hasattr(cfg, name):
            raise SystemExit(f"--flag: Config has no attribute {name!r}")
        cur = getattr(cfg, name)
        if isinstance(cur, bool):
            setattr(cfg, name, bool(int(val)))
        elif isinstance(cur, int):
            setattr(cfg, name, int(val))
        elif isinstance(cur, float):
            setattr(cfg, name, float(val))
        else:
            setattr(cfg, name, val)
    if modes.dispatch is not None:
        parity = modes.dispatch == "parity"
    sampling = ("strict-parity" if modes.strict_parity
                else "parity" if parity else "fast")
    return cfg, parity, sampling


def make_session(seed: int = 0, grid_dim: int = 128, device=None,
                 fit_holdout: bool = False, cfg=None,
                 shapes: str = "sphere"):
    """(scene, session) of the gate: `cfg` (by default `Config()` with
    latent_dim 32) at `grid_dim`, on `device` (the card unless named), on
    the scene of `shapes`. fit_holdout: the scene has HOLDOUT_INSTS
    instances a category, and the session trains all but `holdout`'s."""
    if cfg is None:
        cfg, _, _ = resolve_modes(grid_dim=grid_dim)
    cfg.grid_dim = grid_dim
    insts = HOLDOUT_INSTS if fit_holdout else SCENE["insts_per_cat"]
    scene = make_scene(**{**SCENE, "insts_per_cat": insts}, seed=seed,
                       shape_family=shapes)
    inst_dict = scene.inst_dict
    if fit_holdout:
        held_cls, held = holdout(inst_dict)
        inst_dict = copy.deepcopy(inst_dict)
        del inst_dict[held_cls][held]
    sess = TrainingSession(cfg, inst_dict, scene.sample_dict,
                           cam=scene.cam, device=device)
    return scene, sess


def holdout(inst_dict: dict) -> tuple[int, int]:
    """(cls, id) that --fit-holdout leaves out of training: the first
    category's last instance (ref: scripts/e2e_quality.py:159-172)."""
    held_cls = sorted(c for c in inst_dict if c != 0)[0]
    return held_cls, sorted(inst_dict[held_cls])[-1]


def make_registered_session(seed: int = 0, grid_dim: int = 128,
                            device=None, cfg=None, fit_holdout: bool = False,
                            shapes: str = "sphere", dataset: str = "replica",
                            refined_mask: bool = True):
    """(scene, session, loader, seconds, full loader) of the gate's
    registered mode (ref: scripts/e2e_quality.py:178-247): the scene
    written in the Replica layout under a new temporary directory, loaded
    and registered by `Replica(cfg)` with self-pretrained fields
    (load_pretrained = False), and a session on the registered poses.
    dataset "scannet" (ref: :216-247): the ScanNet layout with the last
    frame's pose inf, `ScanNet(cfg)` with mw = mh = 4 and, with
    `refined_mask`, the mask refinement; the scene's spheres are then
    remapped to the loader's ids (inst + 1, cls + LAYOUT_CLS_OFFSET).
    cfg: the gate's `Config()` with latent_dim 32 by default.
    fit_holdout (ref: :187-214, 238-245): the scene has HOLDOUT_INSTS
    instances a category, `holdout`'s is erased from the training layout's
    instance masks (it takes no part in registration or training), and a
    second, full layout is loaded without registration (the full loader;
    else None). seconds: of writing the layouts (`layout`), of the
    training layout's loader in all (`loader`), and of its stages
    (`frames`, `stage1`, `pretrain`, `uncertainty`, `align`); for ScanNet
    also the frames' parts (`decode`, `resize`, `refine`) and the
    refinement's (`normals`, `image`, `components`, `fill`)."""
    if cfg is None:
        cfg, _, _ = resolve_modes(grid_dim=grid_dim)
    cfg.grid_dim = grid_dim  # live_voxel_size stays 5 mm; the cap rules
    insts = HOLDOUT_INSTS if fit_holdout else SCENE["insts_per_cat"]
    scene = make_scene(**{**SCENE, "insts_per_cat": insts}, seed=seed,
                       shape_family=shapes)
    cfg.dataset_dir = tempfile.mkdtemp(prefix=f"e2e_registered_{dataset}_")
    cfg.width, cfg.height = SCENE["width"], SCENE["height"]
    cfg.fx = cfg.fy = scene.cam.fx
    cfg.cx, cfg.cy = scene.cam.cx, scene.cam.cy
    cfg.load_pretrained = False   # self-pretrained uncertainty fields
    scannet = dataset == "scannet"
    if scannet:
        cfg.dataset_format = "ScanNet"
        cfg.mw = cfg.mh = 4            # edge crop (ref: cfg mw=10)
        cfg.use_refined_mask = refined_mask
    loader = ScanNet if scannet else Replica
    inf_frame = max(scene.sample_dict.keys())

    def write(sc, out_dir):
        if not scannet:
            write_replica_layout(sc, out_dir, cfg.depth_scale)
            return
        write_scannet_layout(sc, out_dir, cfg.depth_scale)
        # one inf pose: the loader skips the frame (ref:
        # src/dataset.py:295-301)
        np.savetxt(os.path.join(out_dir, "pose", f"{inf_frame}.txt"),
                   np.full((4, 4), np.inf))

    t0 = time.time()
    scene_train, cfg_full = scene, None
    if fit_holdout:
        _, held = holdout(scene.inst_dict)
        scene_train = copy.deepcopy(scene)
        for s in scene_train.sample_dict.values():
            m = s["obj_mask"]
            m[m == held] = 0
        cfg_full = copy.deepcopy(cfg)
        cfg_full.dataset_dir = tempfile.mkdtemp(prefix="e2e_fitreg_full_")
        write(scene, cfg_full.dataset_dir)
    write(scene_train, cfg.dataset_dir)
    t1 = time.time()
    for group in ("registration", "scannet", "segmentation"):
        phase_reset(group)
    data = loader(cfg, device=device)
    seconds = {"layout": t1 - t0, "loader": time.time() - t1,
               **phase_timings("registration"), **phase_timings("scannet"),
               **phase_timings("segmentation")}
    data_full = (loader(cfg_full, run_registration=False, device=device)
                 if cfg_full is not None else None)
    if scannet:
        # the loader's ids: inst + 1, cls + LAYOUT_CLS_OFFSET
        for s in scene.spheres:
            s.inst_id += 1
            s.cls_id += LAYOUT_CLS_OFFSET
    sess = TrainingSession(cfg, data.inst_dict, data.sample_dict,
                           device=device)
    return scene, sess, data, seconds, data_full


def registration_report(scene, data) -> dict:
    """Per instance: its category after registration (cls + 100 when
    subcategorized), whether it was its category's template (the argmax
    of the template scores), and its registered T_obj against the
    ground-truth pose: translation error (cm), rotation angle between the
    two frames (degrees; a sphere's is not determined), scale ratio."""
    templates = {}
    for cls_id, counts in (data.template_counts or {}).items():
        if counts:
            templates[cls_id] = max(counts, key=counts.get)
    where = {o: c for c, objs in data.inst_dict.items() if c != 0
             for o in objs}
    out = {}
    for s in scene.spheres:
        cls_id = where.get(s.inst_id)
        if cls_id is None:
            continue  # held out of the training layout
        T = np.asarray(data.inst_dict[cls_id][s.inst_id]["T_obj"],
                       np.float64)
        T_gt = s.gt_T_obj()
        sc = abs(np.linalg.det(T[:3, :3])) ** (1.0 / 3.0)
        sc_gt = abs(np.linalg.det(T_gt[:3, :3])) ** (1.0 / 3.0)
        dR = (T[:3, :3] / sc) @ (T_gt[:3, :3] / sc_gt).T
        angle = math.degrees(math.acos(float(np.clip(
            (np.trace(dR) - 1.0) / 2.0, -1.0, 1.0))))
        out[s.inst_id] = {
            "cls": cls_id, "template": templates.get(s.cls_id) == s.inst_id,
            "count": (data.template_counts or {}).get(s.cls_id, {}).get(
                s.inst_id),
            "t_err_cm": round(100.0 * float(np.linalg.norm(
                T[:3, 3] - T_gt[:3, 3])), 3),
            "rot_deg": round(angle, 2),
            "scale_ratio": round(sc / sc_gt, 4)}
    return out


def fit_loss(sess, m) -> float:
    """The colour and opacity terms of the loss (without the depth term,
    whose 1/sqrt(var) weight grows as the field sharpens)."""
    cfg = sess.cfg
    bg_color = m.bg_color if sess.background is not None else 0.0
    bg_opacity = m.bg_opacity if sess.background is not None else 0.0
    return float((m.cat_color.sum() + bg_color) * cfg.color_scaling
                 + (m.cat_opacity.sum() + bg_opacity) * cfg.opacity_scaling)


def train(sess, iters: int, log=None, parity: bool = False) -> dict:
    """`iters` steps, the first alone, then runs that end every
    CHUNK_STEPS steps: through the fast path, or with `parity` one
    `step_once` a step on the epoch cursor's batches (ref:
    scripts/e2e_quality.py:259-282). The mean category PSNR after each
    run, the colour and opacity loss of the first and the last step, and
    the seconds (device work included)."""
    if parity:
        def advance(k):
            for _ in range(k):
                m = sess.step_once()
            return m
    else:
        sess.enable_fast_path(CHUNK_STEPS)
        advance = sess.run_fast
    if sess.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    first = advance(1)
    fit_first = fit_loss(sess, first)
    m, psnr = first, []
    while sess.iteration < iters:
        m = advance(min(CHUNK_STEPS - sess.iteration % CHUNK_STEPS,
                        iters - sess.iteration))
        psnr.append(round(float(m.cat_psnr.mean()), 2))
        if log is not None and len(psnr) == 1:
            log(f"first {sess.iteration} steps"
                + ("" if parity else " (graph capture included)")
                + f": {time.time() - t0:.1f} s")
    sess.release_prefetch()
    train_s = time.time() - t0
    return {"iters": sess.iteration, "psnr_hist": psnr, "train_s": train_s,
            "steps_per_s": (sess.iteration - 1) / train_s if iters > 1
            else None, "fit_first": fit_first, "fit_last": fit_loss(sess, m),
            "total_last": float(m.total)}


def mesh_and_score(sess, scene, iteration: int, out_dir: str,
                   skip: tuple[int, ...] = ()) -> dict:
    """mesh_scene, then score_shape of each sphere's mesh but those in
    `skip` (a held-out instance, scored through the fit): per-object and
    mean metrics, the seconds of meshing (by phase) and scoring."""
    reset_mesh_timings()
    t0 = time.time()
    written = mesh_scene(sess, out_dir, iteration)
    mesh_s = time.time() - t0
    t0 = time.time()
    per_obj, accs, comps, ratios = {}, [], [], []
    for s in scene.spheres:
        if s.inst_id in skip:
            continue  # scored separately through the fit path
        path = written.get(s.inst_id)
        if path is None:
            per_obj[s.inst_id] = None
            continue
        m, per_obj[s.inst_id] = score_shape(load_mesh(path), s)
        accs.append(m["accuracy"])
        comps.append(m["completion"])
        ratios.append(m["completion_ratio"])
    return {
        "mean_accuracy_cm": round(float(np.mean(accs)), 3) if accs else None,
        "mean_completion_cm": (round(float(np.mean(comps)), 3)
                               if comps else None),
        "mean_completion_ratio_pct": (round(float(np.mean(ratios)), 2)
                                      if ratios else None),
        "n_meshed": len(accs),
        "n_objects": len(scene.spheres),
        "per_object": per_obj,
        "mesh_s": mesh_s,
        "mesh_phase_s": mesh_timings(),
        "score_s": time.time() - t0,
        "mesh_dir": out_dir,
    }


def render_psnr(sess) -> list[float]:
    """The gate's image-space readout (ref: scripts/e2e_quality.py:
    303-317): every trained field composited (`render_scene_view`) from the
    first and the middle dataset pose, at the frames' camera, near
    RENDER_NEAR, RENDER_BINS bins, scored as true MSE PSNR (dB, 2 places)
    against the frame's image."""
    from catnerf_torch.render_views import render_scene_view, scene_far

    out = []
    far = scene_far(sess)
    frames = sorted(sess.sample_dict.keys())
    for fr in {frames[0], frames[len(frames) // 2]}:
        T = np.asarray(sess.sample_dict[fr]["T"], np.float32)
        img, _, _ = render_scene_view(sess, T, sess.cam, near=RENDER_NEAR,
                                      far=far, n_bins=RENDER_BINS)
        gt = np.asarray(sess.sample_dict[fr]["image"], np.float32) / 255.0
        mse = float(np.mean((img - gt) ** 2))
        out.append(round(-10.0 * np.log10(max(mse, 1e-10)), 2))
    return out


def _loader_cloud(data_full, cls_id: int, oid: int, cam) -> np.ndarray:
    """An instance's loader-grade cloud (ref: scripts/e2e_quality.py:
    338-348): its `pcs` on the 0.01 voxel grid that get_all_poses feeds
    registration, or, where the loader kept none, its accumulated cloud."""
    from catnerf_torch.geometry.pointcloud import accumulate_pointcloud

    info = data_full.inst_dict[cls_id][oid]
    pcs = info.get("pcs")
    if pcs is None:
        return accumulate_pointcloud(oid, info["frame_info"],
                                     data_full.sample_dict, cam)
    return geomlib.voxel_downsample(np.asarray(pcs, np.float32), 0.01)


def run_fit_holdout(sess, scene, held: tuple[int, int],
                    steps: int | None = None, data=None, data_full=None,
                    loader_held: tuple[int, int] | None = None):
    """The new-instance path on the held-out instance (ref:
    scripts/e2e_quality.py:319-410): its cloud registered to the union of
    its trained siblings' canonical clouds (`register_new_instance`),
    `fit.fit_instance` with pose refinement on the session's device, the
    fitted field meshed at `adaptive_grid_dim` and scored by
    `score_shape`. GT-pose mode by default: the siblings' and the held-out
    instance's accumulated clouds and ground-truth poses. With the
    registered loader `data` and the full loader `data_full`
    (`make_registered_session(fit_holdout=True)`): the trained instances'
    loader-grade clouds at their ESTIMATED poses, the held-out one's cloud
    and frames from the full layout; nothing touches the ground truth.
    held: (cls, id) in the scene's ids; loader_held: the same in the
    loader's and the session's ids (ScanNet's shift them; by default
    `held`). Returns (the JAX gate's `fit_holdout` dict, the FitResult,
    the seconds of registration, fit, meshing and scoring)."""
    from catnerf_torch.fit import fit_instance
    from catnerf_torch.geometry.pointcloud import accumulate_pointcloud
    from catnerf_torch.geometry.registration import register_new_instance
    from catnerf_torch.mesher.meshing import adaptive_grid_dim, mesh_field

    held_cls, held_out = held
    cls_l, out_l = held if loader_held is None else loader_held
    steps = FIT_STEPS if steps is None else steps
    cfg = sess.cfg
    sec = {}
    t_fit = t0 = time.time()
    if data_full is not None:
        trained = data.inst_dict.get(cls_l, {})
        if cls_l not in sess.cls_ids or len(trained) < 1:
            raise SystemExit(
                f"fit-holdout: category {cls_l} was split or dropped "
                f"during registration (trained ids "
                f"{sorted(data.inst_dict)}); no trained multi-instance "
                f"category to adopt into")
        registered = [(_loader_cloud(data_full, cls_l, oid, sess.cam),
                       info_o["T_obj"])
                      for oid, info_o in sorted(trained.items())]
        pcs_new = _loader_cloud(data_full, cls_l, out_l, sess.cam)
        fi_new = data_full.inst_dict[cls_l][out_l]["frame_info"]
        sdict_fit = data_full.sample_dict
    else:
        registered = []
        for oid in sorted(scene.inst_dict[held_cls]):
            if oid == held_out:
                continue
            info_o = scene.inst_dict[held_cls][oid]
            registered.append((accumulate_pointcloud(
                oid, info_o["frame_info"], scene.sample_dict, sess.cam),
                info_o["T_obj"]))
        fi_new = scene.inst_dict[held_cls][held_out]["frame_info"]
        pcs_new = accumulate_pointcloud(held_out, fi_new, scene.sample_dict,
                                        sess.cam)
        sdict_fit = scene.sample_dict
    T_est, reg_cd = register_new_instance(registered, pcs_new)
    sec["register"] = time.time() - t0
    T_gt = np.asarray(scene.inst_dict[held_cls][held_out]["T_obj"],
                      np.float64)
    s_gt = abs(np.linalg.det(T_gt[:3, :3])) ** (1 / 3)

    t0 = time.time()
    res = fit_instance(sess, cls_l, fi_new, sdict_fit, sess.cam, T_est,
                       out_l, steps=steps, optimize_pose=True)
    sec["fit"] = time.time() - t0
    t0 = time.time()
    params = sess.category_params(cls_l)
    dim = adaptive_grid_dim(res.extent, cfg.live_voxel_size, cfg.grid_dim)
    fmesh = mesh_field(params, cfg, grid_dim=dim, is_background=False,
                       shape_code=res.shape_code,
                       texture_code=res.texture_code, extent=res.extent)
    sec["mesh"] = time.time() - t0
    t0 = time.time()
    fit_metrics = None
    if fmesh is not None:
        # canonical -> scene: one affine
        fmesh.apply_transform(np.asarray(res.T_obj, np.float64))
        sp = next(s for s in scene.spheres if s.inst_id == out_l)
        _, fit_metrics = score_shape(fmesh, sp)
    sec["score"] = time.time() - t0
    out = {
        "held_out": out_l,
        "path": "registered" if data_full is not None else "gt_pose",
        "registration_chamfer": round(reg_cd, 4),
        "pose_center_err_cm": round(100.0 * float(
            np.linalg.norm(res.T_obj[:3, 3] - T_gt[:3, 3])), 3),
        "pose_scale_err_pct": round(float(100.0 * abs(
            abs(np.linalg.det(res.T_obj[:3, :3])) ** (1 / 3) - s_gt)
            / s_gt), 2),
        "fit_steps": res.steps,
        "psnr_prior_init": round(res.init_psnr, 2),
        "psnr_after_fit": round(res.final_psnr, 2),
        "mesh": fit_metrics,
        "wall_s": round(time.time() - t_fit, 1),
    }
    return out, res, sec


def passes(result: dict) -> bool:
    """The gate's pass rule (the JAX package's scripts/e2e_quality.py:
    439-447): every trained object meshed, the means in the band; with a
    fit-holdout, its mesh under 5 cm in accuracy and its PSNR raised."""
    n_trained = result["n_objects"] - (1 if "fit_holdout" in result else 0)
    ok = (result["n_meshed"] == n_trained
          and result["mean_accuracy_cm"] < 5.0
          and result["mean_completion_cm"] < 5.0
          and result["mean_completion_ratio_pct"] > 80.0)
    fh = result.get("fit_holdout")
    if fh is not None:
        ok = (ok and fh["mesh"] is not None
              and fh["mesh"]["accuracy_cm"] < 5.0
              and fh["psnr_after_fit"] > fh["psnr_prior_init"])
    return ok


class GateRun(NamedTuple):
    """What `run` ran: its JSON result, the scene, the trained session,
    and with a fit-holdout the FitResult (else None)."""
    result: dict
    scene: object
    session: TrainingSession
    fit: object


def run(iters: int = 10000, grid_dim: int = 128, seed: int = 0,
        device=None, out: str = "", log=None, registered: bool = False,
        fit_holdout: bool = False, modes: Modes = Modes(),
        cfg=None, dataset: str = "replica",
        refined_mask: bool = True) -> GateRun:
    """The gate: ground-truth poses, or with `registered` the registered
    mode (`make_registered_session`) on the layout of `dataset` (replica
    or scannet; `refined_mask` the ScanNet loader's mask refinement);
    `fit_holdout` adds the new-instance path on a held-out instance;
    `modes` the JAX gate's other flags (`resolve_modes`). cfg: the
    resolved config, for a caller that cuts its registration (the dispatch
    still comes from `modes`)."""
    extra, held, data, data_full = {}, None, None, None
    resolved, parity, sampling = resolve_modes(modes, grid_dim)
    cfg = resolved if cfg is None else cfg
    scannet = registered and dataset == "scannet"
    if registered:
        scene, sess, data, seconds, data_full = make_registered_session(
            seed, grid_dim, device, cfg, fit_holdout, modes.shapes,
            dataset, refined_mask)
        extra = {"registration": registration_report(scene, data),
                 "registration_s": {k: round(v, 3)
                                    for k, v in seconds.items()}}
    else:
        scene, sess = make_session(seed, grid_dim, device, fit_holdout, cfg,
                                   modes.shapes)
    held_l = None
    if fit_holdout:
        held = holdout(scene.inst_dict)
        held_l = ((held[0] + LAYOUT_CLS_OFFSET, held[1] + 1) if scannet
                  else held)
    if iters >= CHUNK_STEPS:  # whole runs, as the JAX package's gate
        iters = iters // CHUNK_STEPS * CHUNK_STEPS
    tr = train(sess, iters, log, parity)
    scored = mesh_and_score(sess, scene, iters,
                            out or tempfile.mkdtemp(prefix="e2e_quality_"),
                            skip=(held_l[1],) if held else ())
    psnr = render_psnr(sess)
    res = None
    if held is not None:
        extra["fit_holdout"], res, sec = run_fit_holdout(
            sess, scene, held, data=data, data_full=data_full,
            loader_held=held_l)
        if log is not None:
            log(f"fit-holdout: {extra['fit_holdout']}; seconds "
                + json.dumps({k: round(v, 3) for k, v in sec.items()}))
    result = {
        "metric": (("e2e_synthetic_quality_registered"
                    + ("_scannet" if scannet else "")) if registered
                   else "e2e_fit_holdout" if held is not None
                   else "e2e_synthetic_quality"),
        "iters": iters,
        "final_psnr": tr["psnr_hist"][-1],
        **{k: scored[k] for k in (
            "mean_accuracy_cm", "mean_completion_cm",
            "mean_completion_ratio_pct", "n_meshed", "n_objects",
            "per_object")},
        "render_psnr": psnr,
        "seed": seed,
        "shapes": modes.shapes,
        "sampling": sampling,
        "flag_overrides": list(modes.flags),
        "dispatch_override": modes.dispatch,
        "device": str(sess.device),
        "train_s": round(tr["train_s"], 3),
        "mesh_s": round(scored["mesh_s"], 3),
        "mesh_phase_s": scored["mesh_phase_s"],
        "score_s": round(scored["score_s"], 3),
        "mesh_dir": scored["mesh_dir"],
        **extra,
    }
    return GateRun(result, scene, sess, res)


# ---------------------------------------------------------------------------
# The flip rule
# ---------------------------------------------------------------------------

def carve_boundary(pts_w: np.ndarray, depths: np.ndarray, T_wc: np.ndarray,
                   K, margin: float) -> np.ndarray:
    """Points whose carve bit two valid float32 evaluations may set
    differently: for some view, the point lies in front of the camera
    and its projected pixel coordinate lies within FLIP_PIXEL of a .5
    rounding boundary or of an image edge, or its depth test within
    FLIP_DEPTH of the margin (float64 on the host)."""
    pts = np.asarray(pts_w, np.float64)
    W, H = depths.shape[1], depths.shape[2]
    fx, fy, cx, cy = (float(k) for k in K)
    near = np.zeros(len(pts), bool)
    for T, depth in zip(np.asarray(T_wc, np.float64), depths):
        pc = (pts - T[:3, 3]) @ T[:3, :3]
        z = pc[:, 2]
        front = z > 0.05 - FLIP_DEPTH
        safe = np.where(np.abs(z) > 1e-6, z, 1.0)
        px = fx * pc[:, 0] / safe + cx
        py = fy * pc[:, 1] / safe + cy
        inside = ((px > -FLIP_PIXEL) & (px < W - 1 + FLIP_PIXEL)
                  & (py > -FLIP_PIXEL) & (py < H - 1 + FLIP_PIXEL))
        on_half = ((np.abs(px - np.floor(px) - 0.5) < FLIP_PIXEL)
                   | (np.abs(py - np.floor(py) - 0.5) < FLIP_PIXEL))
        on_edge = ((np.abs(px) < FLIP_PIXEL) | (np.abs(px - (W - 1))
                                                < FLIP_PIXEL)
                   | (np.abs(py) < FLIP_PIXEL) | (np.abs(py - (H - 1))
                                                  < FLIP_PIXEL)
                   | (np.abs(z - 0.05) < FLIP_DEPTH))
        ix = np.clip(np.round(np.where(inside, px, 0.0)).astype(np.int64),
                     0, W - 1)
        iy = np.clip(np.round(np.where(inside, py, 0.0)).astype(np.int64),
                     0, H - 1)
        obs = depth[ix, iy]
        on_depth = (obs > 0) & (np.abs(z - (obs - margin)) < FLIP_DEPTH)
        near |= front & inside & (on_half | on_depth) | (front & on_edge)
    return near


def count_flips(occ_f32: np.ndarray, u8_a: np.ndarray, u8_b: np.ndarray,
                seen_a: np.ndarray | None = None,
                seen_b: np.ndarray | None = None,
                near_carve: np.ndarray | None = None) -> dict:
    """Hold two uint8 grids (and their carve masks) of the same voxels to
    each other under the flip rule; occ_f32 is one side's float32
    occupancy (before carving). Raises AssertionError on a difference the
    rule does not allow; returns the counts."""
    occ = np.asarray(occ_f32, np.float64)
    a = np.asarray(u8_a).astype(np.int64)
    b = np.asarray(u8_b).astype(np.int64)
    n = a.size
    carve_diff = np.zeros(n, bool)
    if seen_a is not None:
        carve_diff = np.asarray(seen_a) != np.asarray(seen_b)
        bad = carve_diff & ~np.asarray(near_carve)
        if bad.any():
            raise AssertionError(f"{int(bad.sum())} carve bits differ away "
                                 f"from a rounding boundary")
    diff = (a != b) & ~carve_diff
    q = np.clip(occ, 0.0, 1.0) * 255.0
    near_half = np.abs(q - np.floor(q) - 0.5) < FLIP_U8
    if (np.abs(a - b)[diff] > 1).any():
        raise AssertionError("a uint8 voxel differs by more than one "
                             "quantum")
    bad = diff & ~near_half
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} uint8 voxels differ away "
                             f"from a rounding boundary")
    flips = int(diff.sum()) + int(carve_diff.sum())
    if flips > FLIP_SHARE * n:
        raise AssertionError(f"{flips} of {n} voxels flipped, more than "
                             f"{FLIP_SHARE:.1%}")
    return {"voxels": n, "u8_flips": int(diff.sum()),
            "carve_flips": int(carve_diff.sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m catnerf_torch.experimental.e2e_quality",
        description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10000)
    ap.add_argument("--grid-dim", type=int, default=128)
    ap.add_argument("--out", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--registered", action="store_true",
                    help="the registered Replica mode: estimated poses "
                    "instead of the ground truth")
    ap.add_argument("--fit-holdout", action="store_true",
                    help="hold one instance OUT of training, then run the "
                    "new-instance path on it: register its cloud to the "
                    "trained category's canonical union, fit only latent "
                    "codes (+ sim(3) pose) against the frozen MLP "
                    "(catnerf_torch/fit.py), and score its mesh with the "
                    "standard protocol. Uses 3 instances/category so the "
                    "held-out category stays multi-instance.")
    ap.add_argument("--parity", action="store_true",
                    help="train with the reference's sampling semantics "
                    "(per-epoch shuffle cursor, one step_once a step) "
                    "instead of the fast path")
    ap.add_argument("--strict-parity", action="store_true",
                    help="Config.apply_strict_parity() (every "
                    "algorithmic-improvement flag off) and parity dispatch")
    ap.add_argument("--flag", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="a Config override applied after --strict-parity "
                    "(repeatable); bools as 0/1")
    ap.add_argument("--dispatch", choices=("parity", "fast"), default=None,
                    help="override the dispatch that --parity / "
                    "--strict-parity imply")
    ap.add_argument("--shapes", choices=("sphere", "asym", "mixed"),
                    default="sphere",
                    help="the synthetic shape families: sphere, asym "
                    "(ellipsoid / blob / notched box, really rotated) or "
                    "mixed")
    ap.add_argument("--dataset", choices=("replica", "scannet"),
                    default="replica",
                    help="the layout and loader of --registered")
    ap.add_argument("--no-refined-mask", action="store_true",
                    help="scannet only: load the raw instance masks, "
                    "without the geometric-segmentation refinement")
    args = ap.parse_args(argv)
    modes = Modes(args.strict_parity, args.parity, tuple(args.flag),
                  args.dispatch, args.shapes)
    result = run(args.iters, args.grid_dim, args.seed, args.device, args.out,
                 log=lambda s: print(s, file=sys.stderr),
                 registered=args.registered,
                 fit_holdout=args.fit_holdout, modes=modes,
                 dataset=args.dataset,
                 refined_mask=not args.no_refined_mask).result
    print(json.dumps(result))
    return 0 if passes(result) else 1


if __name__ == "__main__":
    sys.exit(main())
