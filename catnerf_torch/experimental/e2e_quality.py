"""End-to-end quality gate: train the synthetic sphere scene, mesh every
object, and score the meshes against the analytic ground truth.

The port of the JAX package's `scripts/e2e_quality.py` in its default
mode (ground-truth object poses, sphere shapes, the fast path), in its
test-time fitting mode (`--fit-holdout`, ground-truth poses, ref:
scripts/e2e_quality.py:69-77, 159-172, 319-410: 3 instances a category,
the first category's last held out of training, then registered to its
category's canonical union, fitted against the frozen MLP (`fit.py`,
1,000 steps with pose refinement), meshed and scored by the same
protocol) and in its registered Replica mode (`--registered`, ref:
scripts/e2e_quality.py:178-247 without --fit-holdout): the scene is
written in the Replica layout (`data/replica.write_replica_layout`) and
loaded through the real pipeline, `Replica(cfg)` with `load_pretrained =
False` — point-cloud accumulation, self-pretrained uncertainty fields on
the device, TEASER-style multi-init alignment, subcategorization — so
training uses ESTIMATED object poses; mesh errors then include any pose
misalignment.
The scene is 3 categories x 2 spheres in 24 frames of 160x120
(`make_scene`, seeded by --seed); the trainer is `Config()` with
latent_dim 32 (the reference's default: bf16 activation storage on the XLA
path), `run_fast` in runs of 100 steps (on a CUDA session each step a
replayed CUDA graph); meshes come from `mesh_scene` at most `--grid-dim`
voxels a side, and each sphere is scored by `score_shape` under the
reference's protocol (accuracy on the mesh cropped to the GT box,
completion, completion ratio under 5 cm; ref:
metric/eval_3D_obj.py:15-34); then the scene composite from two dataset
poses against their frames (`render_psnr`, dB). Prints one JSON line; exits 1 when an object
was not meshed or a mean is outside the gate's band (accuracy and
completion under 5 cm, completion ratio over 80%), or, with
--fit-holdout, when the fitted mesh is missing or 5 cm or more in
accuracy, or the fit did not raise the PSNR.

    python -m catnerf_torch.experimental.e2e_quality            # the card
    python -m catnerf_torch.experimental.e2e_quality --device cpu \\
        --iters 100 --grid-dim 32
    python -m catnerf_torch.experimental.e2e_quality --registered
    python -m catnerf_torch.experimental.e2e_quality --fit-holdout

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
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from catnerf_torch.config import Config
from catnerf_torch.data.replica import Replica, write_replica_layout
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.mesher.mesh import load_mesh
from catnerf_torch.mesher.meshing import (mesh_scene, mesh_timings,
                                          reset_mesh_timings)
from catnerf_torch.metrics.synthetic_eval import score_shape
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


def make_session(seed: int = 0, grid_dim: int = 128, device=None,
                 fit_holdout: bool = False):
    """(scene, session) of the gate: `Config()` with latent_dim 32 and
    `grid_dim`, on `device` (the card unless named). fit_holdout: the
    scene has HOLDOUT_INSTS instances a category, and the session trains
    all but `holdout`'s."""
    cfg = Config()
    cfg.net_hyperparams.latent_dim = 32
    cfg.grid_dim = grid_dim  # live_voxel_size stays 5 mm; the cap rules
    insts = HOLDOUT_INSTS if fit_holdout else SCENE["insts_per_cat"]
    scene = make_scene(**{**SCENE, "insts_per_cat": insts}, seed=seed)
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
                            device=None, cfg=None):
    """(scene, session, loader, seconds) of the gate's registered Replica
    mode (ref: scripts/e2e_quality.py:178-247): the scene written in the
    Replica layout under a new temporary directory, loaded and registered by `Replica(cfg)` with self-pretrained
    fields (load_pretrained = False), and a session on the registered
    poses. cfg: the gate's `Config()` with latent_dim 32 by default.
    seconds: of writing the layout (`layout`), of the loader in all
    (`loader`), and of its stages (`frames`, `stage1`, `pretrain`,
    `uncertainty`, `align`)."""
    if cfg is None:
        cfg = Config()
        cfg.net_hyperparams.latent_dim = 32
    cfg.grid_dim = grid_dim  # live_voxel_size stays 5 mm; the cap rules
    scene = make_scene(**SCENE, seed=seed)
    cfg.dataset_dir = tempfile.mkdtemp(prefix="e2e_registered_replica_")
    cfg.width, cfg.height = SCENE["width"], SCENE["height"]
    cfg.fx = cfg.fy = scene.cam.fx
    cfg.cx, cfg.cy = scene.cam.cx, scene.cam.cy
    cfg.load_pretrained = False   # self-pretrained uncertainty fields
    t0 = time.time()
    write_replica_layout(scene, cfg.dataset_dir, cfg.depth_scale)
    t1 = time.time()
    phase_reset("registration")
    data = Replica(cfg, device=device)
    seconds = {"layout": t1 - t0, "loader": time.time() - t1,
               **phase_timings("registration")}
    sess = TrainingSession(cfg, data.inst_dict, data.sample_dict,
                           device=device)
    return scene, sess, data, seconds


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


def train(sess, iters: int, log=None) -> dict:
    """`iters` steps through the fast path:
    the first step alone, then runs that end every CHUNK_STEPS steps. The
    mean category PSNR after each run, the colour and opacity loss of the
    first and the last step, and the seconds (device work included)."""
    sess.enable_fast_path(CHUNK_STEPS)
    if sess.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    first = sess.run_fast(1)
    fit_first = fit_loss(sess, first)
    m, psnr = first, []
    while sess.iteration < iters:
        m = sess.run_fast(min(CHUNK_STEPS - sess.iteration % CHUNK_STEPS,
                              iters - sess.iteration))
        psnr.append(round(float(m.cat_psnr.mean()), 2))
        if log is not None and len(psnr) == 1:
            log(f"first {sess.iteration} steps (graph capture included): "
                f"{time.time() - t0:.1f} s")
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


def run_fit_holdout(sess, scene, held: tuple[int, int],
                    steps: int | None = None):
    """The new-instance path on the held-out instance (ref:
    scripts/e2e_quality.py:319-410, GT-pose mode): its cloud registered
    to the union of its trained siblings' canonical clouds
    (`register_new_instance`), `fit.fit_instance` with pose refinement on
    the session's device, the fitted field meshed at `adaptive_grid_dim`
    and scored by `score_shape`. Returns (the JAX gate's `fit_holdout`
    dict, the FitResult, the seconds of registration, fit, meshing and
    scoring)."""
    from catnerf_torch.fit import fit_instance
    from catnerf_torch.geometry.pointcloud import accumulate_pointcloud
    from catnerf_torch.geometry.registration import register_new_instance
    from catnerf_torch.mesher.meshing import adaptive_grid_dim, mesh_field

    held_cls, held_out = held
    steps = FIT_STEPS if steps is None else steps
    cfg = sess.cfg
    sec = {}
    t_fit = t0 = time.time()
    registered = []
    for oid in sorted(scene.inst_dict[held_cls]):
        if oid == held_out:
            continue
        info_o = scene.inst_dict[held_cls][oid]
        registered.append((accumulate_pointcloud(
            oid, info_o["frame_info"], scene.sample_dict, sess.cam),
            info_o["T_obj"]))
    info_gt = scene.inst_dict[held_cls][held_out]
    pcs_new = accumulate_pointcloud(held_out, info_gt["frame_info"],
                                    scene.sample_dict, sess.cam)
    T_est, reg_cd = register_new_instance(registered, pcs_new)
    sec["register"] = time.time() - t0
    T_gt = np.asarray(info_gt["T_obj"], np.float64)
    s_gt = abs(np.linalg.det(T_gt[:3, :3])) ** (1 / 3)

    t0 = time.time()
    res = fit_instance(sess, held_cls, info_gt["frame_info"],
                       scene.sample_dict, sess.cam, T_est, held_out,
                       steps=steps, optimize_pose=True)
    sec["fit"] = time.time() - t0
    t0 = time.time()
    params = sess.category_params(held_cls)
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
        sp = next(s for s in scene.spheres if s.inst_id == held_out)
        _, fit_metrics = score_shape(fmesh, sp)
    sec["score"] = time.time() - t0
    out = {
        "held_out": held_out,
        "path": "gt_pose",
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
        fit_holdout: bool = False) -> GateRun:
    """The gate: ground-truth poses, or with `registered` the registered
    Replica mode (`make_registered_session`); `fit_holdout` adds the
    new-instance path on a held-out instance (GT-pose mode)."""
    extra, held = {}, None
    if registered and fit_holdout:
        raise NotImplementedError(
            "--registered --fit-holdout is not in the port yet (ROADMAP.md "
            "Queue 1, item 4c)")
    if registered:
        scene, sess, data, seconds = make_registered_session(
            seed, grid_dim, device)
        extra = {"registration": registration_report(scene, data),
                 "registration_s": {k: round(v, 3)
                                    for k, v in seconds.items()}}
    else:
        scene, sess = make_session(seed, grid_dim, device, fit_holdout)
        held = holdout(scene.inst_dict) if fit_holdout else None
    if iters >= CHUNK_STEPS:  # whole runs, as the JAX package's gate
        iters = iters // CHUNK_STEPS * CHUNK_STEPS
    tr = train(sess, iters, log)
    scored = mesh_and_score(sess, scene, iters,
                            out or tempfile.mkdtemp(prefix="e2e_quality_"),
                            skip=(held[1],) if held else ())
    psnr = render_psnr(sess)
    res = None
    if held is not None:
        extra["fit_holdout"], res, sec = run_fit_holdout(sess, scene,
                                                             held)
        if log is not None:
            log(f"fit-holdout: {extra['fit_holdout']}; seconds "
                + json.dumps({k: round(v, 3) for k, v in sec.items()}))
    result = {
        "metric": ("e2e_synthetic_quality_registered" if registered
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
        "shapes": "sphere",
        "sampling": "fast",
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
    args = ap.parse_args(argv)
    result = run(args.iters, args.grid_dim, args.seed, args.device, args.out,
                 log=lambda s: print(s, file=sys.stderr),
                 registered=args.registered,
                 fit_holdout=args.fit_holdout).result
    print(json.dumps(result))
    return 0 if passes(result) else 1


if __name__ == "__main__":
    sys.exit(main())
