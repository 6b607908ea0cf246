"""3D reconstruction metrics (a copy of the JAX package's
`metrics/metrics3d.py`).

Parity target: metric/metrics.py (accuracy, completion, completion ratio,
chamfer — all mean-NN distances via KD-tree). Uses the first-party C++
KD-tree instead of scipy cKDTree.
"""

from __future__ import annotations

import numpy as np

from catnerf_torch.native.lib import geomlib


def _nn_dist(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """For each point in src, distance to its nearest neighbor in dst
    (ref: metric/metrics.py:4-8)."""
    tree = geomlib.KDTree(dst.astype(np.float32))
    dist, _ = tree.query(src.astype(np.float32))
    return dist


def accuracy(gt_points: np.ndarray, rec_points: np.ndarray) -> float:
    """Mean distance rec -> gt (ref: metric/metrics.py:10-13)."""
    return float(np.mean(_nn_dist(rec_points, gt_points)))


def completion(gt_points: np.ndarray, rec_points: np.ndarray) -> float:
    """Mean distance gt -> rec (ref: metric/metrics.py:16-19)."""
    return float(np.mean(_nn_dist(gt_points, rec_points)))


def completion_ratio(gt_points: np.ndarray, rec_points: np.ndarray,
                     dist_th: float = 0.05) -> float:
    """Fraction of gt points with a reconstruction within dist_th
    (ref: metric/metrics.py:22-28)."""
    d = _nn_dist(gt_points, rec_points)
    return float(np.mean((d < dist_th).astype(np.float64)))


def chamfer(gt_points: np.ndarray, rec_points: np.ndarray) -> float:
    """Symmetric mean chamfer (ref: metric/metrics.py:31-42)."""
    return 0.5 * (accuracy(gt_points, rec_points)
                  + completion(gt_points, rec_points))


def calc_3d_metric(mesh_rec, mesh_ref, n_samples: int = 10000,
                   ref_obb=None, seed: int = 0,
                   rec_crop=None) -> dict[str, float]:
    """Full per-object protocol (ref: metric/eval_3D_obj.py:10-39):
    accuracy computed on the rec mesh cropped to the reference OBB; metrics
    reported x100 (cm / %). Callers that already cropped mesh_rec (e.g. for
    an emptiness pre-check) pass the result as rec_crop so the potentially
    multi-million-face crop runs once, not twice."""
    rng = np.random.default_rng(seed)
    if rec_crop is None and ref_obb is not None:
        rec_crop = mesh_rec.crop_to_obb(
            ref_obb.center, ref_obb.R, ref_obb.extent)
    if rec_crop is not None and len(rec_crop.faces) > 0:
        mesh_rec_crop = rec_crop
    else:
        mesh_rec_crop = mesh_rec
    rec_pc = mesh_rec_crop.sample_surface(n_samples, rng)
    rec_pc_full = mesh_rec.sample_surface(n_samples, rng)
    gt_pc = mesh_ref.sample_surface(n_samples, rng)
    return {
        "accuracy": accuracy(gt_pc, rec_pc) * 100.0,
        "completion": completion(gt_pc, rec_pc_full) * 100.0,
        "completion_ratio": completion_ratio(gt_pc, rec_pc_full) * 100.0,
    }
