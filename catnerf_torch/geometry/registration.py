"""Category-level registration orchestration (L2): a copy of the JAX
package's `geometry/registration.py` whose two device stages, the
per-object field pretraining and the uncertainty scoring, run on the
port's (`geometry/field_pretrain.py`, `geometry/uncertainty.py`), on the
card unless `device` names another.

Parity target: `src/category_registration.py` — three stages driven from the
dataset constructor and cached to `inst_dict.pkl`:

  1. get_all_poses        — per-instance world clouds (unproject / TSDF)
  2. get_uncertainty_fields — template completeness scoring via pretrained
                             vMAP fields (on the device)
  3. align_poses          — TEASER-style multi-init alignment to the
                             template + Chamfer-thresholded
                             subcategorization until fixpoint

The inst_dict contract matches the reference: per instance
{'frame_info', 'pcs', 'T_obj', 'bbox3D'}; background gets {'bbox3D'}.
"""

from __future__ import annotations

import os
import re
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from catnerf_torch.config import Config
from catnerf_torch.data.camera import CameraInfo
from catnerf_torch.geometry.obb import (
    get_bound,
    get_obb,
    get_pose_from_pointcloud,
    get_possible_transform_from_bbox,
)
from catnerf_torch.geometry.pointcloud import (
    accumulate_pointcloud,
    accumulate_pointcloud_tsdf,
    chamfer_unidirectional,
)
from catnerf_torch.geometry.teaser import teaser_fpfh_icp
from catnerf_torch.geometry.uncertainty import (spherical_ray_grid,
                                                uncertainty_score)
from catnerf_torch.ops.sim3 import transform_pointcloud_np
from catnerf_torch.utils import phase_timer


def get_all_poses(inst_dict: dict, sample_dict: dict, cam: CameraInfo,
                  name: str = "replica", max_depth: float = 8.0,
                  want_color: bool = False) -> None:
    """Stage 1 (ref: src/category_registration.py:18-56).

    want_color (ours): additionally store per-point observed RGB for each
    instance cloud (`pcs_rgb`, NN-transferred from the masked unprojected
    pixels so `pcs` itself stays bit-identical) — consumed by the
    appearance-aware candidate tie-break in align_poses."""
    t1 = time.time()
    for cls_id, inst_dict_cls in inst_dict.items():
        if cls_id == 0:
            frame_info = inst_dict_cls["frame_info"]
            if name == "replica":
                bg_pcs = accumulate_pointcloud(0, frame_info, sample_dict, cam)
            else:
                bg_pcs = accumulate_pointcloud_tsdf(
                    0, frame_info, sample_dict, cam, max_depth=max_depth)
            bbox3d = get_bound(bg_pcs)
            inst_dict_cls["bbox3D"] = bbox3d
            inst_dict_cls["pcs"] = bg_pcs
        else:
            for inst_id, info in inst_dict_cls.items():
                if name == "replica":
                    info["pcs"] = accumulate_pointcloud(
                        inst_id, info["frame_info"], sample_dict, cam)
                else:
                    if "pcs" not in info:
                        print(f"{inst_id} missing from refined segmentation")
                        info["T_obj"] = np.eye(4)
                        info["pcs"] = None
                    else:
                        from catnerf_torch.native.lib import geomlib

                        info["pcs"] = geomlib.voxel_downsample(
                            np.asarray(info["pcs"], np.float32), 0.01)
                if want_color and info["pcs"] is not None \
                        and len(info["pcs"]):
                    from catnerf_torch.geometry.pointcloud import \
                        colorize_pointcloud

                    info["pcs_rgb"] = colorize_pointcloud(
                        info["pcs"], inst_id, info["frame_info"],
                        sample_dict, cam)
    print(f"get_all_poses took {time.time() - t1:.1f}s")


def coverage_score(points: np.ndarray, name: str = "replica") -> int:
    """First-party fallback template score when no pretrained vMAP fields
    exist (the reference hard-requires them and raises NotImplementedError,
    ref: src/category_registration.py:93-94): count spherical directions
    (of the same 100x100 grid) whose cone contains observed surface points —
    a completeness proxy equivalent in role to the reliability count."""
    pts = np.asarray(points)
    center = ((pts.max(0) + pts.min(0)) / 2.0 if name == "replica"
              else pts.mean(0))
    rel = pts - center
    norm = np.linalg.norm(rel, axis=-1, keepdims=True) + 1e-12
    rel = rel / norm
    dirs = spherical_ray_grid()
    # direction observed if any point lies within ~2.3 deg of it
    sim = rel @ dirs.T  # (n_pts, n_dirs)
    return int((sim.max(axis=0) > np.cos(np.deg2rad(2.3))).sum())


def get_uncertainty_fields(inst_dict: dict, bbox3d_dict: dict,
                           count_dict: dict, field_dict: dict, cfg: Config,
                           name: str = "replica",
                           load_pretrained: bool = True,
                           sample_dict: dict | None = None,
                           cam=None, device=None) -> None:
    """Stage 2 (ref: src/category_registration.py:58-177). Fills
    count_dict[cls][obj] with the completeness score, bbox3d_dict with a
    per-object bound, field_dict with converted field params (if any).

    load_pretrained=False (where the reference raises NotImplementedError,
    ref: src/category_registration.py:93-94): if sample_dict+cam are given,
    per-object fields are pretrained on-the-fly (geometry/field_pretrain.py)
    and scored with the real uncertainty heuristic; otherwise the geometric
    coverage_score proxy is used.

    device: where the pretraining and the scoring run (the card unless
    named). The pretraining's seconds go to the `registration` phase
    timings as `pretrain`, the scoring's as `uncertainty`."""
    # Collect scoreable objects (stable order).
    todo = []
    for cls_id, inst_dict_cls in inst_dict.items():
        if cls_id == 0:
            continue
        count_dict.setdefault(cls_id, {})
        bbox3d_dict.setdefault(cls_id, {})
        field_dict.setdefault(cls_id, {})
        for obj_id, info in inst_dict_cls.items():
            if info.get("pcs") is None or len(info["pcs"]) == 0:
                count_dict[cls_id][obj_id] = 0
                bbox3d_dict[cls_id][obj_id] = None
            else:
                todo.append((cls_id, obj_id, info))

    pretrained_fields = None
    # Objects with a point cloud but no frame_info (e.g. ScanNet instances
    # surviving only through TSDF accumulation) cannot be ray-pretrained;
    # they take the geometric coverage_score fallback below.
    trainable = {(c, o) for c, o, info in todo if info.get("frame_info")}
    if (not load_pretrained and sample_dict is not None and cam is not None
            and trainable):
        from catnerf_torch.geometry.field_pretrain import \
            pretrain_object_fields

        objects = [(obj_id, info["frame_info"], info["pcs"])
                   for cls_id, obj_id, info in todo
                   if (cls_id, obj_id) in trainable]
        with phase_timer("registration", "pretrain"):
            fields = pretrain_object_fields(
                objects, sample_dict, cam, cfg, steps=cfg.pretrain_steps,
                n_rays=cfg.pretrain_rays, device=device)
        it = iter(fields)
        pretrained_fields = [next(it) if (c, o) in trainable else None
                             for c, o, _ in todo]

    for i, (cls_id, obj_id, info) in enumerate(todo):
        if load_pretrained:
            from catnerf_torch.train.checkpoint import load_vmap_pth

            ckpt_dir = os.path.join(cfg.weight_root, "ckpt", str(obj_id))
            # latest by PARSED iteration number — lexicographic sort
            # misorders unpadded names ('999' > '1500')
            def _it_num(fn: str) -> int:
                nums = re.findall(r"\d+", fn)
                return int(nums[-1]) if nums else -1
            ckpt_paths = sorted(
                (f for f in os.listdir(ckpt_dir) if f.endswith(".pth")),
                key=_it_num)
            if not ckpt_paths:
                raise FileNotFoundError(
                    f"no .pth checkpoints under {ckpt_dir}")
            field = load_vmap_pth(os.path.join(ckpt_dir, ckpt_paths[-1]))
        elif pretrained_fields is not None and pretrained_fields[i] is not None:
            field = pretrained_fields[i]
        else:
            bbox3d_dict[cls_id][obj_id] = None
            count_dict[cls_id][obj_id] = coverage_score(info["pcs"], name)
            continue
        field_dict[cls_id][obj_id] = field
        bbox3d_dict[cls_id][obj_id] = field.get("bbox")
        # the uniforms come from a generator seeded with obj_id, as the JAX
        # package's from PRNGKey(obj_id)
        with phase_timer("registration", "uncertainty"):
            count, _, _ = uncertainty_score(field, info["pcs"], name=name,
                                            seed=obj_id, device=device)
        count_dict[cls_id][obj_id] = count

    # Template selection (align_poses argmax) must compare LIKE scores: a
    # category mixing field-scored instances (uncertainty reliability
    # count) with fallback-scored ones (geometric coverage count) would
    # argmax across two incomparable 0..10000 scales. Re-score such mixed
    # categories uniformly with the geometric coverage count, which every
    # instance with a cloud supports.
    for cls_id, inst_dict_cls in inst_dict.items():
        if cls_id == 0:
            continue
        scored = [o for o, info in inst_dict_cls.items()
                  if info.get("pcs") is not None and len(info["pcs"])]
        if not scored:
            continue
        fielded = [o for o in scored if o in field_dict.get(cls_id, {})]
        if fielded and len(fielded) < len(scored):
            for o in scored:
                count_dict[cls_id][o] = coverage_score(
                    inst_dict_cls[o]["pcs"], name)


N_THETA, N_PHI = 24, 12


def _bin_index(pts_c: np.ndarray) -> np.ndarray:
    """Spherical-direction bin index of each canonical-frame point as seen
    from the pivot (passed as origin)."""
    d = pts_c / (np.linalg.norm(pts_c, axis=-1, keepdims=True) + 1e-12)
    theta = np.arctan2(d[:, 1], d[:, 0])  # [-pi, pi]
    phi = np.arccos(np.clip(d[:, 2], -1.0, 1.0))  # [0, pi]
    it = np.clip(((theta + np.pi) / (2 * np.pi) * N_THETA).astype(int),
                 0, N_THETA - 1)
    ip = np.clip((phi / np.pi * N_PHI).astype(int), 0, N_PHI - 1)
    return it * N_PHI + ip


def _coverage_bins(pts_c: np.ndarray) -> np.ndarray:
    """Direction-coverage fingerprint of a canonical-frame cloud."""
    bins = np.zeros(N_THETA * N_PHI, bool)
    bins[_bin_index(pts_c)] = True
    return bins


def _erode_bins(bins: np.ndarray) -> np.ndarray:
    """Erode a direction-coverage mask by one bin (theta wraps around), so
    masking excludes the rim band where a covered bin borders a hole."""
    g = bins.reshape(N_THETA, N_PHI)
    out = g.copy()
    out &= np.roll(g, 1, axis=0) & np.roll(g, -1, axis=0)
    out[:, 1:] &= g[:, :-1]
    out[:, :-1] &= g[:, 1:]
    return out.reshape(-1)


def _masked_chamfer(src_w: np.ndarray, src_c: np.ndarray, dst_w: np.ndarray,
                    dst_bins: np.ndarray, scale: float,
                    min_overlap: float = 0.3) -> float:
    """Unidirectional Chamfer restricted to source points lying in
    directions the destination has confidently OBSERVED — the coverage
    mask eroded by one bin, so points just past the hole rim don't bleed in
    (ours). For complete clouds this reduces to the reference's criterion;
    for partial observations it measures shape compatibility on the overlap
    instead of punishing complementary alignments (a ground-truth alignment
    of two half-observed instances scores ~2x eta1 on the unmasked metric
    purely because each covers the other's hole). Returns inf when fewer
    than `min_overlap` of the source points are comparable."""
    mask = _erode_bins(dst_bins)[_bin_index(src_c)]
    if mask.mean() < min_overlap:
        return float("inf")
    return float(chamfer_unidirectional(src_w[mask], dst_w)) / scale


def _polish_candidate(source_w: np.ndarray, template_w: np.ndarray,
                      T_rel: np.ndarray, s_tmpl: float,
                      fracs: tuple = (0.15, 0.05, 0.02),
                      max_iter: int = 50, rounds: int = 1) -> np.ndarray:
    """Final re-refinement of the winning registration candidate
    (VERDICT r1 item #2): multi-scale point-to-point ICP on the FULL
    resolution clouds (the in-solver ICP runs on voxel-downsampled clouds at
    the 0.01 noise bound, ref: teaser_fpfh_icp.py:85-89, whose ~voxel/2
    quantization error it cannot see past), then one Umeyama similarity
    step to absorb residual scale error. Returns the corrected T_rel.

    fracs/max_iter: ICP schedule — the tie-break uses a lighter schedule on
    downsampled clouds for its 24 composed candidates (scoring only needs
    ~cm alignment; this box is single-core, so work = wall time)."""
    from catnerf_torch.native.lib import geomlib

    src = np.asarray(source_w, np.float32)
    tmpl = np.asarray(template_w, np.float32)
    # bound the ICP cost on dense clouds: half-voxel quantization at
    # 0.01*s averages out over thousands of correspondences (the Umeyama
    # step is a correspondence MEAN), so this does not move the ~0.05 cm
    # pose-error budget, but keeps the single-core polish O(8k) points
    if len(src) > 8000:
        src = geomlib.voxel_downsample(src, 0.01 * s_tmpl)
    if len(tmpl) > 8000:
        tmpl = geomlib.voxel_downsample(tmpl, 0.01 * s_tmpl)
    T_acc = np.eye(4)
    src_tf = transform_pointcloud_np(src, T_rel).astype(np.float32)
    kd = geomlib.KDTree(tmpl)
    # rounds > 1: an initial scale error shrinks the Umeyama inlier mask
    # (distant points exceed the 0.05*s gate), so one pass under-corrects;
    # a second ICP+Umeyama cycle from the corrected pose recovers the rest.
    for _ in range(max(1, rounds)):
        for frac in fracs:
            T_acc, _, _ = geomlib.icp(src_tf, tmpl,
                                      max_corr_dist=float(frac * s_tmpl),
                                      init=T_acc, max_iter=max_iter)

        cur = transform_pointcloud_np(src_tf, T_acc)
        dist, idx = kd.query(cur.astype(np.float32))
        mask = dist < 0.05 * s_tmpl
        if mask.sum() >= 16:
            a = cur[mask]
            b = tmpl[idx[mask]].astype(np.float64)
            ca, cb = a.mean(0), b.mean(0)
            a0, b0 = a - ca, b - cb
            H = b0.T @ a0
            U, S, Vt = np.linalg.svd(H)
            d = np.sign(np.linalg.det(U @ Vt))
            D = np.diag([1.0, 1.0, d])
            R = U @ D @ Vt
            var_a = (a0**2).sum()
            s = float((S * np.diag(D)).sum() / var_a) if var_a > 0 else 1.0
            s = float(np.clip(s, 0.8, 1.25))  # polish; big scale was solved
            T_sim = np.eye(4)
            T_sim[:3, :3] = s * R
            T_sim[:3, 3] = cb - s * (R @ ca)
            T_acc = T_sim @ T_acc
    return T_acc @ T_rel


#: Valid values for cfg.reg_candidate_scale / align_poses(candidate_scale=).
CANDIDATE_SCALE_STATS = ("obb", "rms_vox", "trim_ext", "aabb")


def candidate_scale_stat(pts: np.ndarray, statistic: str,
                         vox: float) -> float:
    """Rotation-invariant per-cloud size statistic for the candidate sim(3)
    scale ratio in align_poses (the "obb" statistic lives inline there —
    it reuses the template OBB already computed for the pose).

    Both statistics run on a voxel-downsampled cloud so per-view point
    density cannot bias them (the r2 objection to raw RMS), and both are
    functions of point-to-centroid radii so they are rotation-invariant:

    - "rms_vox": RMS radius. Low weight on the extreme rim -> robust to
      the rim erosion TSDF clouds + eroded masks produce (the r4
      asym-ScanNet diagnosis: OBB extents of eroded clouds under-measure
      the object 10-28% and every instance spuriously subcategorized).
    - "trim_ext": 95th-percentile radius — a robust 'max extent' between
      OBB (p100 of the support) and RMS; kept for A/B
      (VERDICT r4 next-round item 1).
    """
    from catnerf_torch.native.lib import geomlib

    p = geomlib.voxel_downsample(np.asarray(pts, np.float32), vox)
    r = np.sqrt(((p - p.mean(0)) ** 2).sum(-1))
    if statistic == "rms_vox":
        return float(np.sqrt((r ** 2).mean()))
    if statistic == "trim_ext":
        return float(np.quantile(r, 0.95))
    raise ValueError(f"unknown candidate-scale statistic {statistic!r}")


def align_poses(inst_dict: dict, bbox3d_dict: dict, count_dict: dict,
                field_dict: dict, name: str = "replica",
                multi_init_pose: bool = True, eta1: float = 0.06,
                eta2: float = 0.15, eta3: float = 0.12,
                scale_aware: bool = True, appearance: bool = True,
                candidate_scale: str = "obb") -> None:
    """Stage 3 (ref: src/category_registration.py:179-324).

    scale_aware (ours; the reference registers raw metric clouds): normalize
    source and rotated-template clouds to unit half-extent before the rigid
    solve and fold the relative scale back into a sim(3) T_rel. Rigid
    registration cannot absorb intra-category size variation (a 20% radius
    difference alone costs ~0.17 normalized Chamfer — past eta2), so the
    reference wrongly subcategorizes same-shape different-size instances,
    losing exactly the category-level field sharing the method is built on.
    The per-instance sim(3) scale is re-estimated downstream from the
    aligned cloud (get_obb), so a scaled T_rel is fully consistent.
    Disable (cfg.scale_aware_registration=false) for strict parity.

    appearance (ours; requires scale_aware and `pcs_rgb` colors from
    get_all_poses(want_color=True)): geometry alone cannot disambiguate a
    near-symmetric shape's flip (the reference shares this limit — its
    candidate selection is geometry-only raw Chamfer,
    ref: src/category_registration.py:257-267; measured: a notched box's
    true alignment beats its 180-degree flip by only 13% Chamfer, inside
    registration noise). Accept-band candidates whose observed per-point
    RGB disagrees with the template's beyond the best candidate's color
    score (+margin) are dropped before the coverage tie-break; candidates
    with too little overlap to judge stay eligible (complementary
    alignments must not be excluded by 'cannot judge')."""
    t1 = time.time()
    env_scale = os.environ.get("CATNERF_CAND_SCALE")
    if env_scale and env_scale != candidate_scale:
        # diag/experiment hook; announce so gate logs stay reproducible
        # (a stray env var must never silently change registration numerics)
        print(f"align_poses: CATNERF_CAND_SCALE={env_scale!r} overrides "
              f"configured candidate_scale={candidate_scale!r}")
        candidate_scale = env_scale
    if candidate_scale not in CANDIDATE_SCALE_STATS:
        raise ValueError(
            f"candidate_scale must be one of {CANDIDATE_SCALE_STATS}, "
            f"got {candidate_scale!r}")
    cls_id_add = 100 if name == "replica" else 10000

    def _usable_cloud(pts) -> bool:
        return pts is not None and np.asarray(pts).size >= 9  # >= 3 points

    while bbox3d_dict:
        for cls_id in list(bbox3d_dict.keys()):
            obj_ids = list(bbox3d_dict[cls_id].keys())
            inst_dict_cls = inst_dict[cls_id]

            # Instances without a usable point cloud (e.g. ScanNet objects
            # missing from the refined segmentation set pcs=None,
            # registration.py get_all_poses) cannot be registered or serve
            # as template: keep them at their default pose and drop them
            # from the alignment instead of crashing on max() of None.
            skipped = [o for o in obj_ids
                       if not _usable_cloud(inst_dict_cls[o].get("pcs"))]
            for o in skipped:
                inst_dict_cls[o].setdefault("T_obj", np.eye(4))
                print(f"skipping unregistrable obj {o} in cls {cls_id} "
                      f"(no usable point cloud)")
            obj_ids = [o for o in obj_ids if o not in skipped]
            if not obj_ids:
                bbox3d_dict.pop(cls_id)
                continue

            counts = [count_dict[cls_id].get(o, 0) for o in obj_ids]
            idx_repr = int(np.argmax(counts)) if len(counts) > 1 else 0

            obj_id_repr = obj_ids[idx_repr]
            template_pts = inst_dict_cls[obj_id_repr]["pcs"]
            t_prolog = time.time()
            T_obj, bbox3d = get_pose_from_pointcloud(template_pts)
            if T_obj is None:
                T_obj = np.eye(4)
            inst_dict_cls[obj_id_repr]["T_obj"] = T_obj
            if bbox3d is not None:
                inst_dict_cls[obj_id_repr]["bbox3D"] = bbox3d

            other_obj_ids = [o for i, o in enumerate(obj_ids) if i != idx_repr]
            if not other_obj_ids:
                bbox3d_dict.pop(cls_id)
                continue

            T_obj_template = np.copy(T_obj)
            scale_template = np.linalg.det(T_obj_template[:3, :3]) ** (1 / 3)
            T_obj_template[:3, :3] /= scale_template
            template_np_w = np.asarray(template_pts)

            if multi_init_pose:
                transform_list = get_possible_transform_from_bbox()
            else:
                transform_list = [np.eye(4)]
            targets = [transform_pointcloud_np(template_np_w, T)
                       for T in transform_list]

            # one KD-tree over the template serves all 24 candidate
            # chamfers per source object (math-identical to per-call
            # chamfer_unidirectional; the rebuild was ~40% of align time
            # on dense clouds — this box is single-core)
            from catnerf_torch.native.lib import geomlib

            kd_tmpl = geomlib.KDTree(np.asarray(template_np_w, np.float32))

            def cd_to_template(pts_w):
                d, _ = kd_tmpl.query(np.asarray(pts_w, np.float32))
                return float(d.mean())

            if os.environ.get("CATNERF_REG_DEBUG"):
                print(f"  template prolog {time.time() - t_prolog:.1f}s "
                      f"({len(template_np_w)} pts)")

            for obj_id in other_obj_ids:
                source_np_w = np.asarray(inst_dict_cls[obj_id]["pcs"])
                scale_source = np.max(
                    source_np_w.max(0) - source_np_w.min(0)) / 2.0
                # Candidate sim(3) scale k must be ROTATION-INVARIANT too:
                # the world-AABB half-extent above inflates by up to the
                # box-diagonal factor for a source sitting rotated in the
                # world (measured: 0.334 vs 0.275 object-aligned on a
                # jittered notched box => every candidate composed a ~25%
                # shrink, the shrunken flip then beat the true rotation on
                # the masked score). The OBB max half-extent is the same
                # extent statistic (keeps the r2 partial-cloud robustness
                # over the density-biased RMS ratio) but orientation-free,
                # and matches the template's own scale convention
                # (get_pose_from_pointcloud). scale_source (AABB) is kept
                # for the parity path's chamfer normalization.
                T_src_obb, _ = get_pose_from_pointcloud(source_np_w)
                scale_source_obb = (
                    abs(np.linalg.det(T_src_obb[:3, :3])) ** (1.0 / 3.0)
                    if T_src_obb is not None else scale_source)
                # Alternative candidate-scale statistics (r4-end diagnosis:
                # rim-eroded TSDF clouds give OBB extents 10-28% under the
                # object and every asym-ScanNet instance spuriously
                # subcategorized) — see candidate_scale_stat above. The
                # SAME statistic runs on both clouds so shared erosion
                # cancels in the ratio.
                if candidate_scale in ("rms_vox", "trim_ext"):
                    vox_cand = 0.02 * scale_template
                    scale_source_cand = candidate_scale_stat(
                        source_np_w, candidate_scale, vox_cand)
                    scale_tmpl_cand = candidate_scale_stat(
                        template_np_w, candidate_scale, vox_cand)
                else:
                    scale_source_cand = scale_source_obb
                    scale_tmpl_cand = scale_template
                c_src = (source_np_w.max(0) + source_np_w.min(0)) / 2.0
                # TEASER-normalization scale/center must be ROTATION-
                # INVARIANT (centroid + RMS radius). The AABB half-extent
                # is not: for the same shape at different orientations it
                # differs by up to the extent anisotropy, so the rigid
                # solver would see two mismatched-scale clouds and converge
                # in a wrong basin (measured on identical-cloud pairs:
                # 53-180 deg rotation error + 6.6% phantom scale;
                # tests/test_registration.py::
                # test_asym_shape_rotation_recovery_exact_shape).
                cm_src = source_np_w.mean(0)
                rms_src = float(np.sqrt(
                    ((source_np_w - cm_src) ** 2).sum(-1).mean()))

                # register source onto each rotated template, pick best by
                # normalized unidirectional chamfer
                # (ref: category_registration.py:241-267). The 24 init-pose
                # solves are independent and the native solver releases the
                # GIL, so they run on a thread pool (the reference runs them
                # sequentially).
                def solve_one(args):
                    """One (init, target) solve -> list of candidates.

                    scale_aware: BOTH correspondence strategies are solved
                    and both candidates enter the band — spc (the
                    reference's all-pairs sampling; orientation-weak but
                    the long-validated behavior on noisy partial clouds)
                    AND FPFH + mutual-NN on rotation-invariantly
                    normalized clouds (centroid + RMS radius). The spc
                    path's 10k-random-sample correspondences + 0.01 noise
                    bound cannot bracket a real rotation (identical-cloud
                    pairs landed 53-180 deg off); FPFH recovers those to
                    ~0.1 deg, but degenerates on featureless shapes — so
                    neither replaces the other
                    (tests/test_registration.py::
                    test_asym_shape_rotation_recovery_exact_shape).
                    The strict-parity path (scale_aware=False) keeps the
                    reference's spc-only semantics."""
                    T_init, target = args
                    out = []
                    if scale_aware:
                        s_tgt = np.max(target.max(0) - target.min(0)) / 2.0
                        cm_tgt = target.mean(0)
                        rms_tgt = float(np.sqrt(
                            ((target - cm_tgt) ** 2).sum(-1).mean()))
                        src_n = (source_np_w - cm_src) / rms_src
                        tgt_n = (target - cm_tgt) / rms_tgt
                        # Candidates compose with an extent-ratio scale
                        # (r2 behavior — more robust than the RMS ratio on
                        # PARTIAL clouds, whose point-density weighting
                        # biases RMS by coverage), measured via OBB max
                        # half-extents so it is rotation-invariant on both
                        # sides (r4 fix; see scale_source_obb above);
                        # rotation/translation come from the normalized
                        # rigid solve. Centroid mapping preserved:
                        # x -> k R (x - cm_src) + rms_tgt t + cm_tgt.
                        # `norm` stays the AABB-based target half-extent so
                        # the normalized-chamfer eta thresholds keep their
                        # meaning.
                        # "aabb" restores the r3 behavior (the per-
                        # target world-AABB ratio, rotation-VARIANT — its
                        # inflation incidentally compensated rim erosion)
                        # as an A/B control for the r4 asym-ScanNet
                        # regression (VERDICT r5 item #1).
                        if candidate_scale == "aabb":
                            k = s_tgt / scale_source
                        else:
                            k = scale_tmpl_cand / scale_source_cand
                        if os.environ.get("CATNERF_REG_DEBUG2"):
                            print(f"  solve k={k:.3f} s_tgt={s_tgt:.3f} "
                                  f"scale_source={scale_source:.3f} "
                                  f"obb={scale_source_obb:.3f} "
                                  f"rms_src={rms_src:.3f} rms_tgt={rms_tgt:.3f}")
                        # diag/experiment hook (scripts/diag_registration
                        # A/Bs): "spc" restores the r3 single-strategy solve
                        modes = ((True, 0.1), (False, 0.08))
                        if os.environ.get("CATNERF_REG_MODES") == "spc":
                            modes = ((True, 0.1),)
                        for spc_mode, vox in modes:
                            R_rel, t_rel = teaser_fpfh_icp(
                                src_n, tgt_n, voxel_size=vox, spc=spc_mode)
                            T_cand = np.eye(4)
                            T_cand[:3, :3] = k * R_rel
                            T_cand[:3, 3] = (rms_tgt * t_rel[:, 0] + cm_tgt
                                             - k * (R_rel @ cm_src))
                            T_rel = np.linalg.inv(T_init) @ T_cand
                            src_tf = transform_pointcloud_np(source_np_w,
                                                             T_rel)
                            cd = cd_to_template(src_tf) / s_tgt
                            out.append((cd, T_rel, src_tf))
                    else:
                        R_rel, t_rel = teaser_fpfh_icp(
                            source_np_w, target, voxel_size=0.1, spc=True)
                        T_cand = np.eye(4)
                        T_cand[:3, :3] = R_rel
                        T_cand[:3, 3:] = t_rel
                        T_rel = np.linalg.inv(T_init) @ T_cand
                        src_tf = transform_pointcloud_np(source_np_w, T_rel)
                        out.append((cd_to_template(src_tf) / scale_source,
                                    T_rel, src_tf))
                    return out

                pairs = list(zip(transform_list, targets))
                workers = min(8, len(pairs), os.cpu_count() or 1)
                t_solve = time.time()
                if workers > 1:
                    with ThreadPoolExecutor(max_workers=workers) as pool:
                        results = [r for rs in pool.map(solve_one, pairs)
                                   for r in rs]
                else:
                    results = [r for p_ in pairs for r in solve_one(p_)]
                t_solve = time.time() - t_solve
                best_cd = min(r[0] for r in results)
                # accept-grade band: any candidate below eta1 is a valid
                # registration by the algorithm's own acceptance criterion
                band = [r for r in results
                        if r[0] <= max(best_cd + 0.02, eta1)]
                opposite_cd = None
                if scale_aware:
                    # run even when the solver band has a single candidate:
                    # the composed symmetry candidates below are what
                    # surfaces complementary alignments, and a thin band is
                    # precisely the case where the solver's only answer
                    # stacked the instances' blind spots (measured: 4.1 cm
                    # center error / 9.3% clipped surface on the ScanNet
                    # gate's cls 130 once an inf-pose frame thinned its
                    # coverage; the tie-break path was skipped on
                    # band==1)
                    # Complementarity tie-break (ours): registration of
                    # (near-)rotation-symmetric shapes is ambiguous, and the
                    # pure-Chamfer winner aligns the instances' OBSERVED
                    # regions — stacking their observation blind spots at
                    # the same place in the shared canonical frame, where
                    # the category field then has a mutual unsupervised
                    # hole (measured: 84% vs 100% completion ratio on the
                    # registered gate's sphere categories). Among
                    # accept-grade candidates — scored by the
                    # overlap-restricted masked Chamfer, since the unmasked
                    # one punishes exactly the alignments that cover the
                    # template's hole — prefer the one whose canonical
                    # coverage union with the template is largest.
                    Rt = T_obj_template[:3, :3]  # rotation (scale divided)
                    tt = T_obj_template[:3, 3]

                    def canon(pts_w):
                        return (pts_w - tt) @ Rt / scale_template

                    # Candidate SCORING runs on voxel-downsampled clouds
                    # (0.04 * scale): the quantization is uniform across
                    # candidates so ranking is preserved, and the box is
                    # single-core — full-res scoring of ~30 candidates was
                    # the dominant align_poses cost. Final acceptance
                    # values (eta thresholds) are recomputed at full
                    # resolution on the winner only.
                    from catnerf_torch.native.lib import geomlib

                    src_ds = geomlib.voxel_downsample(
                        np.asarray(source_np_w, np.float32),
                        0.04 * scale_template)
                    tmpl_ds = geomlib.voxel_downsample(
                        np.asarray(template_np_w, np.float32),
                        0.04 * scale_template)

                    # Appearance tie-break setup: colors for the
                    # downsampled clouds by NN transfer from the full-res
                    # colored clouds (pcs_rgb rows align with pcs rows).
                    tmpl_rgb_full = inst_dict_cls[obj_id_repr].get("pcs_rgb")
                    src_rgb_full = inst_dict_cls[obj_id].get("pcs_rgb")
                    use_color = (appearance and tmpl_rgb_full is not None
                                 and src_rgb_full is not None)
                    if use_color:
                        kd_src_full = geomlib.KDTree(
                            np.asarray(source_np_w, np.float32))
                        _, i_s = kd_src_full.query(src_ds)
                        src_ds_rgb = np.asarray(src_rgb_full)[i_s]
                        _, i_t = kd_tmpl.query(tmpl_ds)
                        tmpl_ds_rgb = np.asarray(tmpl_rgb_full)[i_t]
                        # Per-cloud mean-centering: the discriminative
                        # signal is the SPATIAL color pattern, not the
                        # per-instance base albedo — two instances of a
                        # category may be differently colored overall
                        # (measured: uncentered scoring dropped the
                        # complementary winner on the sphere gate's
                        # different-hue pair, 0.94 -> 1.25 cm / 98.8%).
                        src_ds_rgb = src_ds_rgb - src_ds_rgb.mean(0)
                        tmpl_ds_rgb = tmpl_ds_rgb - tmpl_ds_rgb.mean(0)
                        kd_tmpl_ds = geomlib.KDTree(
                            np.asarray(tmpl_ds, np.float32))
                        r_color = 0.06 * scale_template

                        def color_cd(s_pts):
                            """Symmetric mean RGB disagreement over
                            close NN pairs (within r_color); None when
                            neither direction has enough overlap to
                            judge. s_pts rows are transformed src_ds rows,
                            so src_ds_rgb stays aligned."""
                            s32 = np.asarray(s_pts, np.float32)
                            vals = []
                            d, ix = kd_tmpl_ds.query(s32)
                            close = d < r_color
                            if close.sum() >= max(30, 0.05 * len(s32)):
                                vals.append(float(np.abs(
                                    src_ds_rgb[close]
                                    - tmpl_ds_rgb[ix[close]]).mean()))
                            kd_s = geomlib.KDTree(s32)
                            d2, ix2 = kd_s.query(
                                np.asarray(tmpl_ds, np.float32))
                            close2 = d2 < r_color
                            if close2.sum() >= max(30,
                                                   0.05 * len(tmpl_ds)):
                                vals.append(float(np.abs(
                                    tmpl_ds_rgb[close2]
                                    - src_ds_rgb[ix2[close2]]).mean()))
                            return max(vals) if vals else None

                    cd0, T0, src0 = min(band, key=lambda r: r[0])
                    tmpl_c = canon(tmpl_ds)
                    union_c = np.concatenate(
                        [tmpl_c, canon(transform_pointcloud_np(src_ds, T0))])
                    # pivot = estimated object center (the canonical origin
                    # is the template-OBB center, biased toward the
                    # observed side)
                    pivot_c = (union_c.min(0) + union_c.max(0)) / 2.0
                    pivot_w = tt + scale_template * (Rt @ pivot_c)
                    tmpl_bins = _coverage_bins(tmpl_c - pivot_c)
                    tmpl_c_full = canon(template_np_w)
                    tmpl_bins_full = _coverage_bins(tmpl_c_full - pivot_c)

                    def masked_cd(src_w, dst_w, dst_bins):
                        return _masked_chamfer(
                            src_w, canon(src_w) - pivot_c, dst_w,
                            dst_bins, scale_template)

                    def masked_cd_sym(src_w, dst_w=None, dst_bins=None):
                        """Symmetric masked score. The forward direction
                        alone is blind to offsets along the template's hole
                        direction — displaced source points land in the
                        masked-out region, so an inflated sphere slid into
                        the hole scores well (measured: +18.6% scale,
                        9.3 cm center error accepted at masked cd 0.010,
                        scripts/diag_registration.py). Template→source,
                        masked by the SOURCE's coverage, sees exactly those
                        offsets; score = max of both.

                        A direction scoring inf (overlap < the default 30%
                        floor) retries at a 2% floor, exactly like the
                        final-acceptance fallback below: complementary
                        (blind-spot-filling) candidates are precisely the
                        low-overlap ones, and 'cannot judge' must not
                        exclude them from the accept band the coverage
                        tie-break selects from."""
                        dst_w = tmpl_ds if dst_w is None else dst_w
                        dst_bins = tmpl_bins if dst_bins is None else dst_bins
                        src_c = canon(src_w) - pivot_c
                        src_bins_ = _coverage_bins(src_c)
                        dst_c = canon(dst_w) - pivot_c
                        fwd = masked_cd(src_w, dst_w, dst_bins)
                        if not np.isfinite(fwd):
                            fwd = _masked_chamfer(src_w, src_c, dst_w,
                                                  dst_bins, scale_template,
                                                  min_overlap=0.02)
                        bwd = _masked_chamfer(dst_w, dst_c, src_w,
                                              src_bins_, scale_template)
                        if not np.isfinite(bwd):
                            bwd = _masked_chamfer(dst_w, dst_c, src_w,
                                                  src_bins_, scale_template,
                                                  min_overlap=0.02)
                        return max(fwd, bwd)

                    def union_of(src_w):
                        return int((_coverage_bins(canon(src_w) - pivot_c)
                                    | tmpl_bins).sum())

                    def coverage_key(src_w):
                        """Primary: canonical coverage union (fill the
                        template's blind spots). Secondary: intersection —
                        among near-max-union candidates prefer the one
                        with the most MUTUAL observation, since a
                        complementary alignment with little overlap leaves
                        a slide direction unconstrained by data (measured
                        ~0.18-canonical-unit pair offset on the ScanNet
                        gate's low-overlap category)."""
                        bins = _coverage_bins(canon(src_w) - pivot_c)
                        return (int((bins | tmpl_bins).sum()),
                                int((bins & tmpl_bins).sum()))

                    # the per-init ICP pulls every candidate toward maximum
                    # overlap, collapsing rotation diversity; re-expand it
                    # by composing symmetry rotations about the pivot. The
                    # pivot is only an estimate, so a composed candidate
                    # starts with a translation offset of roughly
                    # 2·sin(θ/2)·|pivot error|, and its sim(3) scale is
                    # inherited from the overlap-fit winner — the
                    # multi-scale ICP + Umeyama similarity polish removes
                    # both handicaps before scoring (without it, every
                    # complementary candidate loses the accept band purely
                    # on pivot/scale error; measured 0.07 vs 0.024).
                    def compose_one(Q):
                        Rq_w = Rt @ Q[:3, :3] @ Rt.T
                        T_q = np.eye(4)
                        T_q[:3, :3] = Rq_w
                        T_q[:3, 3] = pivot_w - Rq_w @ pivot_w
                        return _polish_candidate(src_ds, tmpl_ds, T_q @ T0,
                                                 scale_template,
                                                 fracs=(0.12, 0.05),
                                                 max_iter=25, rounds=2)

                    # the native ICP releases the GIL; refine concurrently.
                    # Band candidates get the SAME light polish as the
                    # composed ones before scoring: their sim(3) scale is
                    # only the AABB-ratio initializer (up to ~5% off under
                    # rotation), and a uniform scale error flattens the
                    # masked-sym scores toward a common value, hiding the
                    # true-vs-flipped gap the tie-break cap needs
                    # (identical-cloud notched-box pairs scored 0.0375
                    # for BOTH until polished; 0.005 vs 0.039 after).
                    def polish_band(T):
                        return _polish_candidate(src_ds, tmpl_ds, T,
                                                 scale_template,
                                                 fracs=(0.12, 0.05),
                                                 max_iter=25, rounds=2)

                    t_comp = time.time()
                    compose_Qs = get_possible_transform_from_bbox()
                    if os.environ.get("CATNERF_REG_NO_COMPOSE"):
                        # diag A/B hook: solver-evidence candidates only
                        compose_Qs = []
                    with ThreadPoolExecutor(max_workers=workers) as pool:
                        band_pol = list(pool.map(polish_band,
                                                 [r[1] for r in band]))
                        cand_Ts = band_pol + list(pool.map(
                            compose_one, compose_Qs))
                    cands = [(T, transform_pointcloud_np(src_ds, T))
                             for T in cand_Ts]
                    t_comp = time.time() - t_comp

                    t_score = time.time()
                    scored = [(masked_cd_sym(s), T, s) for T, s in cands]
                    t_score = time.time() - t_score
                    if os.environ.get("CATNERF_REG_DEBUG"):
                        # stash for out-of-band inspection (diag scripts)
                        align_poses._debug_cands = [(m, np.copy(T))
                                                    for m, T, _ in scored]
                    if os.environ.get("CATNERF_REG_DEBUG"):
                        print(f"  stage times: solve {t_solve:.1f}s "
                              f"compose {t_comp:.1f}s score {t_score:.1f}s")
                    mbest = min(m for m, _, _ in scored)
                    # Tie-break ELIGIBILITY: the r2 accept-grade band
                    # (mbest + 0.02, floored at eta1 — tuned on the noisy
                    # partial-cloud gates) CAPPED at 3x the best score.
                    # The cap is what keeps a score-DOMINATED outlier out:
                    # a 7x-worse 180-degree flip of a notched box used to
                    # win the coverage tie-break on +4 bins (identical-
                    # cloud pairs, tests/test_registration.py::
                    # test_asym_shape_rotation_recovery_exact_shape),
                    # while genuinely ambiguous candidates (sphere
                    # complementarity: scores within ~1.2-2x of best) stay
                    # eligible. The mbest+0.008 floor keeps the cap from
                    # over-pruning when mbest is at noise level.
                    cap_mult = float(os.environ.get("CATNERF_REG_CAP",
                                                    "3.0"))
                    tie_band = min(max(mbest + 0.02, eta1),
                                   max(cap_mult * mbest, mbest + 0.008))
                    ok = [c for c in scored if c[0] <= tie_band]
                    if os.environ.get("CATNERF_REG_DEBUG"):
                        for m_, T_, s_ in scored:
                            c_ = color_cd(s_) if use_color else None
                            print(f"  cand masked_sym={m_:.4f} "
                                  f"union={union_of(s_)} "
                                  f"rgb={'-' if c_ is None else round(c_, 4)} "
                                  f"ok={m_ <= tie_band}")
                    # Appearance tie-break — STRICTLY SUBORDINATE to the
                    # coverage objective: color only discriminates among
                    # candidates whose canonical coverage union is within
                    # 2 bins of the maximum. Pre-filtering the whole band
                    # by color was measured to drop the complementary
                    # coverage winner when instance textures are unrelated
                    # (randomly rotated checker on spheres: 0.94 ->
                    # 1.24 cm / 98.8% gate regression); within a
                    # coverage-equivalent set (a near-symmetric shape's
                    # true-vs-flip pair has identical coverage), color is
                    # exactly the right discriminator.
                    if use_color and len(ok) > 1:
                        best_union = max(union_of(c[2]) for c in ok)
                        top = [c for c in ok
                               if union_of(c[2]) >= best_union - 2]
                        if len(top) > 1:
                            cscores = [color_cd(c[2]) for c in top]
                            judged = [c for c in cscores if c is not None]
                            # act only on a CLEAR signal (max-min >= 0.03:
                            # texture-free shapes carry no information)
                            if judged and max(judged) - min(judged) >= 0.03:
                                c_min = min(judged)
                                c_cut = c_min + max(0.02, 0.25 * c_min)
                                kept = [cand for cand, cs_
                                        in zip(top, cscores)
                                        if cs_ is None or cs_ <= c_cut]
                                if os.environ.get("CATNERF_REG_DEBUG"):
                                    for (m_, _, s_), cs_ in zip(top,
                                                                cscores):
                                        print(
                                            f"  color cand sym={m_:.4f} "
                                            f"rgb={cs_ if cs_ is None else round(cs_, 4)} "
                                            f"kept={cs_ is None or cs_ <= c_cut}")
                                if kept:
                                    ok = kept
                    score_selected, T_rel, src_tf_ds = max(
                        ok, key=lambda c: coverage_key(c[2]))
                    union_selected = union_of(src_tf_ds)

                    # polish (full-res ICP maximizes overlap, which can
                    # rotate the winner back onto the template's observed
                    # region — keep only if the coverage union and the
                    # symmetric score survive)
                    t_epilog = time.time()
                    T_pol = _polish_candidate(source_np_w, template_np_w,
                                              T_rel, scale_template,
                                              rounds=3)
                    src_pol_ds = transform_pointcloud_np(src_ds, T_pol)
                    score_pol = masked_cd_sym(src_pol_ds)
                    union_pol = union_of(src_pol_ds)
                    s_sel = abs(np.linalg.det(T_rel[:3, :3])) ** (1 / 3)
                    s_pol = abs(np.linalg.det(T_pol[:3, :3])) ** (1 / 3)
                    dR_pol = (T_pol[:3, :3] / s_pol) @ \
                        (T_rel[:3, :3] / s_sel).T
                    rot_delta = np.degrees(np.arccos(np.clip(
                        (np.trace(dR_pol) - 1.0) / 2.0, -1.0, 1.0)))
                    if ((union_pol >= union_selected - 2
                         and score_pol <= score_selected + 0.01)
                            or (score_pol <= score_selected - 0.005
                                and rot_delta < 10.0)):
                        # second arm: a NEAR-RIGID polish (scale/translation
                        # correction, e.g. Umeyama absorbing a mis-scaled
                        # candidate) may shed boundary coverage bins and is
                        # kept on a clear score win; a polish that ROTATED
                        # the winner is the ICP-pulled-back-onto-overlap
                        # failure that undoes complementarity (re-measured
                        # r3: 18-22 cm ScanNet craters) and must still pass
                        # the union guard above
                        T_rel = T_pol

                    # acceptance values at FULL resolution on the winner
                    src_tf = transform_pointcloud_np(source_np_w, T_rel)
                    chamfer_unidir = masked_cd(src_tf, template_np_w,
                                               tmpl_bins_full)
                    if not np.isfinite(chamfer_unidir):
                        # <30% of source points comparable — exactly the
                        # complementary alignments the coverage tie-break
                        # selects. 'Cannot judge' must not read as 'poor
                        # fit' (inf > eta2 force-subcategorized them):
                        # judge shape compatibility on whatever overlap
                        # exists, down to 2% of points; only a virtually
                        # zero-overlap pair stays inf and splits.
                        chamfer_unidir = _masked_chamfer(
                            src_tf, canon(src_tf) - pivot_c, template_np_w,
                            tmpl_bins_full, scale_template,
                            min_overlap=0.02)
                    src_bins = _coverage_bins(canon(src_tf) - pivot_c)
                    if os.environ.get("CATNERF_REG_DEBUG"):
                        print(f"  epilog {time.time() - t_epilog:.1f}s")

                    def opposite_cd():
                        return _masked_chamfer(
                            template_np_w, tmpl_c_full - pivot_c, src_tf,
                            src_bins, scale_template)
                else:
                    # parity path (scale_aware False): raw unidirectional-
                    # Chamfer selection, no polish (ref:
                    # src/category_registration.py:257-267)
                    chamfer_unidir, T_rel, src_tf = min(results,
                                                        key=lambda r: r[0])
                    # Reference quirk, surfaced by the executed-reference
                    # A/B (tests/test_reference_exec_align.py): in the
                    # multi-init branch the mid-band OPPOSITE chamfer is
                    # computed against `inst_pcs_transformed`, a stale
                    # loop variable still holding the LAST init's
                    # transformed cloud — not the argmin-selected one
                    # (ref: src/category_registration.py:258-283).
                    # Preserved verbatim under strict parity; the
                    # scale_aware path scores the selected candidate.
                    src_tf_opp = results[-1][2] if multi_init_pose \
                        else src_tf
                print(f"registered obj {obj_id} in cls {cls_id}: "
                      f"chamfer={chamfer_unidir:.4f}")

                if chamfer_unidir > eta2:
                    subcategorize = True
                elif chamfer_unidir < eta1:
                    subcategorize = False
                else:
                    if opposite_cd is not None:
                        chamfer_opp = opposite_cd()
                    else:
                        chamfer_opp = chamfer_unidirectional(
                            template_np_w, src_tf_opp) / scale_template
                    subcategorize = chamfer_opp > eta3

                if subcategorize:
                    cls_id_sub = cls_id + cls_id_add
                    inst_dict.setdefault(cls_id_sub, {})[obj_id] = \
                        inst_dict_cls[obj_id]
                    count_dict.setdefault(cls_id_sub, {})[obj_id] = \
                        count_dict[cls_id][obj_id]
                    bbox3d_dict.setdefault(cls_id_sub, {})[obj_id] = \
                        bbox3d_dict[cls_id][obj_id]
                    if cls_id in field_dict and obj_id in field_dict[cls_id]:
                        field_dict.setdefault(cls_id_sub, {})[obj_id] = \
                            field_dict[cls_id].pop(obj_id)
                    inst_dict_cls.pop(obj_id, None)
                    count_dict[cls_id].pop(obj_id, None)
                    bbox3d_dict[cls_id].pop(obj_id, None)
                else:
                    T_obj_new = np.linalg.inv(T_rel) @ T_obj_template
                    inst_dict_cls[obj_id]["T_obj"] = T_obj_new
                    if scale_aware:
                        # per-instance sim(3) scale from the registration
                        # itself: s_i = s_template / s(T_rel). The
                        # reference re-derives it from the observed
                        # canonical extent (get_obb), whose inherited-
                        # origin bias inflates it on partial observations
                        # — breaking cross-instance canonical-scale
                        # consistency (measured +22.7% on a partial
                        # sphere, scripts/diag_registration.py).
                        s_rel = np.linalg.det(
                            T_rel[:3, :3]) ** (1.0 / 3.0)
                        get_obb(inst_dict_cls[obj_id],
                                scale=scale_template / s_rel)
                    else:
                        get_obb(inst_dict_cls[obj_id])

            if scale_aware:
                _recenter_canonical_frame(inst_dict_cls)
            bbox3d_dict.pop(cls_id)
    print(f"align_poses took {time.time() - t1:.1f}s")


def _recenter_canonical_frame(inst_dict_cls: dict) -> None:
    """Shift a category's shared canonical origin to the bbox center of the
    UNION of its members' canonical clouds (ours; applied under
    scale_aware). The reference keeps the template-OBB center as the
    canonical origin, which on partially observed templates is biased
    toward the observed side — measured up to 0.24 canonical units on the
    ScanNet gate (scripts/diag_registration.py --dataset scannet), putting
    8-21% of the true surface outside the mesh-eval grid and off-center in
    the ray-sampling bounds. Union coverage cancels per-instance blind
    spots, so the recentered origin approaches the true object center.
    T_obj maps canonical -> world (p_w = s R p_c + t): shifting canonical
    coords by c* updates t_i += s_i R_i c*; extents are recomputed about
    the new origin (get_obb, per-instance scale preserved)."""
    members = [o for o, info in inst_dict_cls.items()
               if info.get("pcs") is not None
               and np.asarray(info["pcs"]).size >= 9  # skip empty clouds
               and "T_obj" in info]
    if not members:
        return
    canon_clouds = []
    for o in members:
        T = np.asarray(inst_dict_cls[o]["T_obj"], np.float64)
        s_o = np.linalg.det(T[:3, :3]) ** (1.0 / 3.0)
        R_o = T[:3, :3] / s_o
        pts = np.asarray(inst_dict_cls[o]["pcs"], np.float64)
        canon_clouds.append(((pts - T[:3, 3]) @ R_o) / s_o)
    union = np.concatenate(canon_clouds)
    c_star = (union.min(0) + union.max(0)) / 2.0
    for o in members:
        info = inst_dict_cls[o]
        T = np.asarray(info["T_obj"], np.float64)
        s_o = np.linalg.det(T[:3, :3]) ** (1.0 / 3.0)
        T[:3, 3] = T[:3, 3] + T[:3, :3] @ c_star
        info["T_obj"] = T
        get_obb(info, scale=s_o)


def run_registration(inst_dict: dict, sample_dict: dict, cam: CameraInfo,
                     cfg: Config, name: str = "replica",
                     device=None) -> dict:
    """Full preprocessing pipeline, mutating inst_dict in place
    (invoked from the dataset ctor, ref: src/dataset.py:67-88). The
    seconds of each stage go to the `registration` phase timings
    (`utils.phase_timings("registration")`): stage1, pretrain,
    uncertainty, align. Returns the template scores {cls: {obj: count}}
    that align_poses chose each category's template by (its argmax)."""
    bbox3d_dict: dict = {}
    count_dict: dict = {}
    field_dict: dict = {}
    with phase_timer("registration", "stage1"):
        get_all_poses(inst_dict, sample_dict, cam, name=name,
                      max_depth=cfg.max_depth,
                      want_color=(cfg.appearance_tie_break
                                  and cfg.scale_aware_registration))
    get_uncertainty_fields(inst_dict, bbox3d_dict, count_dict, field_dict,
                           cfg, name=name,
                           load_pretrained=cfg.load_pretrained,
                           sample_dict=sample_dict, cam=cam, device=device)
    counts = {c: dict(v) for c, v in count_dict.items()}
    with phase_timer("registration", "align"):
        align_poses(inst_dict, bbox3d_dict, count_dict, field_dict,
                    name=name, multi_init_pose=cfg.multi_init_pose,
                    eta1=cfg.eta1, eta2=cfg.eta2, eta3=cfg.eta3,
                    scale_aware=cfg.scale_aware_registration,
                    appearance=cfg.appearance_tie_break,
                    candidate_scale=cfg.reg_candidate_scale)
    return counts


def register_new_instance(registered: list[tuple[np.ndarray, np.ndarray]],
                          new_pcs: np.ndarray, *,
                          multi_init_pose: bool = True):
    """sim(3) pose for a NEW instance of an already-registered category.

    registered: [(pcs_world, T_obj), ...] for instances already in the
    category's canonical frame. The target is the UNION of their canonical
    clouds — denser than any single template and exactly the geometry the
    trained field was supervised in — so this composes with test-time code
    fitting (the JAX package's fit.py) into observations -> pose -> codes without
    re-running the full category registration (align_poses re-derives the
    template pose from its OBB, which after the post-alignment recentering
    would land in a DIFFERENT canonical frame than the trained one).

    Returns (T_obj_new, cd): the canonical->world sim(3) pose and the
    normalized unidirectional Chamfer of the aligned cloud to the target
    (the same acceptance score align_poses thresholds with eta1).
    """
    from catnerf_torch.native.lib import geomlib

    canon = []
    for pcs, T in registered:
        T = np.asarray(T, np.float64)
        s = abs(np.linalg.det(T[:3, :3])) ** (1.0 / 3.0)
        R = T[:3, :3] / s
        canon.append(((np.asarray(pcs, np.float64) - T[:3, 3]) @ R) / s)
    target = np.concatenate(canon)

    src = np.asarray(new_pcs, np.float64)
    if src.size < 9:
        raise ValueError("new instance cloud has fewer than 3 points")
    # Rotation-invariant normalization (centroid + RMS radius), matching
    # align_poses' solve_one: AABB half-extents change with orientation,
    # which fed the rigid solver mismatched-scale clouds. The composed
    # sim(3) scale below still uses the AABB ratio (robust on partial
    # clouds).
    c_src = src.mean(0)
    rms_src = float(np.sqrt(((src - c_src) ** 2).sum(-1).mean()))
    src_n = (src - c_src) / rms_src
    s_src_aabb = float(np.max(src.max(0) - src.min(0)) / 2.0)

    s_tgt = float(np.max(target.max(0) - target.min(0)) / 2.0)

    inits = (get_possible_transform_from_bbox() if multi_init_pose
             else [np.eye(4)])
    kd = geomlib.KDTree(np.asarray(target, np.float32))

    def run_inits(spc: bool, voxel: float):
        best = None
        for T_init in inits:
            # rotate the canonical target through the bbox symmetry
            # (canonical frame = bbox frame, so the 24 inits apply
            # directly), register the normalized source onto it, undo the
            # init — the same scale-aware composition as align_poses'
            # solve_one
            tgt_rot = target @ T_init[:3, :3].T + T_init[:3, 3]
            ct = tgt_rot.mean(0)
            rms_t = float(np.sqrt(((tgt_rot - ct) ** 2).sum(-1).mean()))
            tgt_n = (tgt_rot - ct) / rms_t
            st_aabb = float(np.max(tgt_rot.max(0) - tgt_rot.min(0)) / 2.0)
            R_rel, t_rel = teaser_fpfh_icp(src_n, tgt_n, voxel_size=voxel,
                                           spc=spc)
            k = st_aabb / s_src_aabb
            T_cand = np.eye(4)
            T_cand[:3, :3] = k * R_rel
            T_cand[:3, 3] = (rms_t * t_rel[:, 0] + ct
                             - k * (R_rel @ c_src))
            T_rel = np.linalg.inv(T_init) @ T_cand  # world -> canonical
            src_tf = transform_pointcloud_np(src, T_rel)
            d, _ = kd.query(np.asarray(src_tf, np.float32))
            cd = float(d.mean()) / s_tgt
            if best is None or cd < best[0]:
                best = (cd, T_rel)
        return best

    # FPFH first (rotation-capable on featured shapes, ~0.1 deg on
    # identical-cloud pairs); if no init reaches accept grade — FPFH
    # degenerates on featureless/symmetric shapes like spheres — retry
    # with the reference's all-pairs spc correspondences and keep the
    # better of the two.
    best = run_inits(spc=False, voxel=0.08)
    if best[0] > 0.06:
        best_spc = run_inits(spc=True, voxel=0.1)
        if best_spc[0] < best[0]:
            best = best_spc

    cd, T_rel = best
    return np.linalg.inv(T_rel), cd
