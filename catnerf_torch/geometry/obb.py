"""Oriented bounding boxes + pose initialisation from point clouds: a
copy of the JAX package's `geometry/obb.py` on the port's OrientedBBox.

Replaces trimesh.bounds.oriented_bounds (qhull) and the reference's pose
helpers (ref: src/utils.py:249-320). Minimum-volume OBB via convex-hull
face normals (exact for the rotation aligning one box face with a hull
face — the standard O(F·N) approximation qhull-based oriented_bounds uses).
"""

from __future__ import annotations

from itertools import permutations

import numpy as np

from catnerf_torch.data.scene import OrientedBBox


def oriented_bounds(points: np.ndarray):
    """(transform_world_from_box 4x4, extents (3,)) — min-volume OBB over
    convex hull face normals. Returns None on degenerate input (the
    reference catches QhullError and returns None, src/utils.py:254-256)."""
    pts = np.asarray(points, np.float64)
    if len(pts) < 4:
        return None
    try:
        from scipy.spatial import ConvexHull

        hull = ConvexHull(pts)
    except Exception:
        return None
    hull_pts = pts[hull.vertices]

    best = None
    # candidate z-axes: hull face normals. On noisy dense clouds the hull
    # has thousands of near-duplicate face normals and the per-normal
    # caliper pass dominated registration wall time (11.9 s on a 30k-point
    # noisy sphere); 0.01 rounding (~0.6 deg axis resolution) + a 256-cap
    # keeps the min-volume search while bounding the loop. The in-plane
    # angle search below stays exhaustive per candidate axis.
    normals = hull.equations[:, :3]
    normals = np.unique(np.round(normals, 2), axis=0)
    if len(normals) > 256:
        normals = normals[np.linspace(0, len(normals) - 1, 256, dtype=int)]
    for nz in normals:
        nz = nz / np.linalg.norm(nz)
        # project to the plane and find min-area rectangle via rotating
        # calipers over the 2D hull
        ref = np.array([1.0, 0, 0]) if abs(nz[0]) < 0.9 else np.array([0, 1.0, 0])
        u = np.cross(nz, ref)
        u /= np.linalg.norm(u)
        v = np.cross(nz, u)
        p2 = np.stack([hull_pts @ u, hull_pts @ v], -1)
        try:
            from scipy.spatial import ConvexHull as CH2

            h2 = CH2(p2)
        except Exception:
            continue
        poly = p2[h2.vertices]
        edges = np.diff(np.vstack([poly, poly[:1]]), axis=0)
        angles = np.arctan2(edges[:, 1], edges[:, 0])
        z = hull_pts @ nz
        zmin, zmax = z.min(), z.max()
        for ang in np.unique(np.round(angles, 6)):
            c, s = np.cos(ang), np.sin(ang)
            R2 = np.array([[c, s], [-s, c]])
            rot = poly @ R2.T
            mn, mx = rot.min(0), rot.max(0)
            area = np.prod(mx - mn)
            vol = area * (zmax - zmin)
            if best is None or vol < best[0]:
                axis_u = c * u + s * v
                axis_v = -s * u + c * v
                R = np.stack([axis_u, axis_v, nz], -1)  # box axes as columns
                center_local = np.array([(mn[0] + mx[0]) / 2,
                                         (mn[1] + mx[1]) / 2,
                                         (zmin + zmax) / 2])
                extents = np.array([mx[0] - mn[0], mx[1] - mn[1], zmax - zmin])
                best = (vol, R, center_local, extents)
    if best is None:
        return None
    _, R, center_local, extents = best
    if np.linalg.det(R) < 0:
        R[:, 2] = -R[:, 2]
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = R @ center_local
    return T, extents


def get_bound(points: np.ndarray) -> OrientedBBox | None:
    """OBB with extents floored at 10 cm (ref: src/utils.py:249-268)."""
    out = oriented_bounds(points)
    if out is None:
        print("fail to get initial pose from instance point cloud")
        return None
    T, extents = out
    extents = np.maximum(extents, 0.10)
    return OrientedBBox(center=T[:3, 3].copy(), R=T[:3, :3].copy(),
                        extent=extents)


def get_pose_from_pointcloud(points: np.ndarray):
    """Template sim(3) pose from an OBB: rotation scaled by max(extent)/2
    (ref: src/utils.py:286-296)."""
    bbox3d = get_bound(points)
    if bbox3d is None:
        return None, None
    scale = np.max(bbox3d.extent) / 2.0
    T_obj = np.eye(4)
    T_obj[:3, 3] = bbox3d.center
    T_obj[:3, :3] = bbox3d.R * scale
    return T_obj, bbox3d


def get_obb(inst_info: dict, scale: float | None = None) -> None:
    """Recompute an instance's OBB in its canonical frame and re-scale
    T_obj by max(extent)/2 (ref: src/utils.py:270-284). Mutates inst_info.

    scale (ours): override for the re-derived sim(3) scale. The reference
    derives it from the observed canonical extent, which measures
    2*max(max, -min) about the INHERITED canonical origin — on partially
    observed instances the template-OBB-center offset inflates that by up
    to ~25% (measured +22.7%, scripts/diag_registration.py), breaking the
    cross-instance canonical-scale consistency the shared category field
    depends on. scale_aware registration passes the registration's own
    scale estimate (s_template / s(T_rel)) instead; the extent stays
    reference-semantics (world units) either way."""
    Two = np.copy(inst_info["T_obj"])
    scale_before = np.linalg.det(Two[:3, :3]) ** (1.0 / 3.0)
    Two[:3, :3] = Two[:3, :3] / scale_before
    bbox3d = OrientedBBox(center=Two[:3, 3].copy(), R=Two[:3, :3].copy(),
                          extent=None)
    points_w = np.asarray(inst_info["pcs"])
    points_o = (points_w - Two[:3, 3]) @ Two[:3, :3]  # R^T (p - t)
    extent = 2 * np.max(
        np.stack([points_o.max(axis=0), -points_o.min(axis=0)], -1), axis=-1)
    extent = np.maximum(extent, 0.10)
    bbox3d.extent = extent
    s = float(scale) if scale is not None else float(np.max(extent / 2.0))
    inst_info["T_obj"][:3, :3] = Two[:3, :3] * s
    inst_info["bbox3D"] = bbox3d


def get_possible_transform_from_bbox() -> list[np.ndarray]:
    """24 axis-permutation/sign rotations for multi-init registration
    (ref: src/utils.py:298-320)."""
    transform_list = []
    axes = np.eye(3)
    for axis_index in permutations([0, 1, 2], 2):
        for i in range(4):
            x_axis = axes[axis_index[0]].copy()
            y_axis = axes[axis_index[1]].copy()
            if i == 1:
                x_axis *= -1
            elif i == 2:
                y_axis *= -1
            elif i == 3:
                x_axis *= -1
                y_axis *= -1
            z_axis = np.cross(x_axis, y_axis)
            T = np.eye(4)
            T[:3, :3] = np.stack([x_axis, y_axis, z_axis], -1)  # columns
            transform_list.append(T)
    return transform_list
