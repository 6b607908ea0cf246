"""Analytic-GT mesh scoring for synthetic scenes (a copy of the JAX
package's `metrics/synthetic_eval.py`).

The quality gate's scoring recipe (experimental/e2e_quality.py; the JAX
package shares it with its reference-trajectory comparison): marching
cubes on the shape's object-frame SDF gives the exact GT surface, and
reconstructions are
scored under the reference's eval protocol — accuracy on the rec mesh
cropped to the GT OBB, 10k/200k point sampling, <5 cm completion ratio
(ref: metric/eval_3D_obj.py:15-34, metric/metrics.py:17-28).
"""

from __future__ import annotations

import numpy as np

from catnerf_torch.data.scene import OrientedBBox
from catnerf_torch.mesher.mesh import TriMesh
from catnerf_torch.metrics.metrics3d import calc_3d_metric
from catnerf_torch.native.lib import geomlib


def gt_shape_mesh(shape, n: int = 64) -> TriMesh:
    """Analytic GT surface for any synthetic shape: marching cubes on the
    object-frame SDF (sigmoid-occupancy, the same numerics the original
    sphere-only gate used), vertices posed into the world."""
    ext = np.asarray(shape.object_extent, np.float64)
    axes = [np.linspace(-0.65 * e, 0.65 * e, n) for e in ext]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    p = np.stack([X, Y, Z], -1).reshape(-1, 3)
    sdf = shape.sdf_obj(p).reshape(n, n, n)
    sref = float(np.max(ext)) / 2.0
    occ = 1.0 / (1.0 + np.exp(sdf * 40.0 / sref))
    v, f = geomlib.marching_cubes(occ.astype(np.float32), 0.5)
    v = v / (n - 1) * 1.3 * ext - 0.65 * ext
    v = v @ np.asarray(shape.R, np.float64).T + np.asarray(shape.center)
    return TriMesh(v, f)


def score_shape(rec_mesh: TriMesh, shape):
    """Score a reconstruction against a synthetic shape's analytic GT.
    Returns (raw metrics dict, rounded JSON dict)."""
    obb = OrientedBBox(center=np.asarray(shape.center, np.float64),
                       R=np.asarray(shape.R, np.float64),
                       extent=1.1 * np.asarray(shape.object_extent,
                                               np.float64))
    m = calc_3d_metric(rec_mesh, gt_shape_mesh(shape), ref_obb=obb)
    return m, {"accuracy_cm": round(m["accuracy"], 3),
               "completion_cm": round(m["completion"], 3),
               "completion_ratio_pct": round(m["completion_ratio"], 2)}
