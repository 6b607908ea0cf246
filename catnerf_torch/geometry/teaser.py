"""Robust global registration: correspondences -> max-clique -> GNC-TLS ->
ICP refinement. A copy of the JAX package's `geometry/teaser.py` on the
port's geometry library.

Parity target: `teaser_fpfh_icp` / `TEASER_FPFH_ICP`
(ref: src/teaser_utils/teaser_fpfh_icp.py:12-171, helpers.py:14-75), built
on the first-party C++ solvers instead of teaserpp_python/Open3D.

Pipeline (spc=True, the category-registration path,
ref: category_registration.py:250):
  voxel downsample both clouds (0.1 m) -> all-pairs correspondences capped
  at 10,000 -> consistency-graph max clique (noise bound 0.01) -> GNC-TLS
  rigid solve -> point-to-point ICP at the noise bound (<=100 iters).
With spc=False: FPFH features + mutual-NN correspondences at the voxel-size
noise bound.
"""

from __future__ import annotations

import numpy as np

from catnerf_torch.native.lib import geomlib

MAX_CORRESPONDENCES = 10000  # (ref: teaser_fpfh_icp.py:71-74)
MAX_CLIQUE_NODES = 6000      # adjacency-matrix budget for the clique solver


def find_correspondences_fpfh(src_feats: np.ndarray, dst_feats: np.ndarray,
                              mutual_filter: bool = True):
    """Mutual nearest neighbors in 33-dim FPFH space
    (ref: helpers.py:27-52)."""
    # brute-force via matmul (n x m distance matrix); fine at downsampled sizes
    d2 = (
        np.sum(src_feats**2, -1)[:, None]
        + np.sum(dst_feats**2, -1)[None, :]
        - 2.0 * src_feats @ dst_feats.T
    )
    nn12 = np.argmin(d2, axis=1)
    if not mutual_filter:
        return np.arange(len(src_feats)), nn12
    nn21 = np.argmin(d2, axis=0)
    mutual = nn21[nn12] == np.arange(len(src_feats))
    return np.nonzero(mutual)[0], nn12[mutual]


def teaser_fpfh_icp(source_points: np.ndarray, target_points: np.ndarray,
                    voxel_size: float = 0.05, spc: bool = False,
                    rng: np.random.Generator | None = None):
    """Register source onto target: returns (R, t) with target ~ R @ src + t
    (ref: teaser_fpfh_icp.py:12-100)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    src_down = geomlib.voxel_downsample(
        np.asarray(source_points, np.float32), voxel_size)
    tar_down = geomlib.voxel_downsample(
        np.asarray(target_points, np.float32), voxel_size)

    if spc:
        noise_bound = 0.01
        # all-pairs correspondences (ref: teaser_fpfh_icp.py:34-36)
        si = np.repeat(np.arange(len(src_down)), len(tar_down))
        ti = np.tile(np.arange(len(tar_down)), len(src_down))
        if len(si) > MAX_CORRESPONDENCES:
            sel = rng.choice(len(si), MAX_CORRESPONDENCES, replace=False)
            si, ti = si[sel], ti[sel]
        src_corr, tar_corr = src_down[si], tar_down[ti]
    else:
        noise_bound = voxel_size
        radius_n, radius_f = 2 * voxel_size, 5 * voxel_size
        sn = geomlib.estimate_normals(src_down, radius_n, 30)
        tn = geomlib.estimate_normals(tar_down, radius_n, 30)
        sf = geomlib.compute_fpfh(src_down, sn, radius_f, 100)
        tf = geomlib.compute_fpfh(tar_down, tn, radius_f, 100)
        ci, cj = find_correspondences_fpfh(sf, tf, mutual_filter=True)
        src_corr, tar_corr = src_down[ci], tar_down[cj]

    if len(src_corr) > MAX_CLIQUE_NODES:
        sel = rng.choice(len(src_corr), MAX_CLIQUE_NODES, replace=False)
        clique_src, clique_tar = src_corr[sel], tar_corr[sel]
    else:
        clique_src, clique_tar = src_corr, tar_corr

    T = np.eye(4)
    if len(clique_src) >= 3:
        clique = geomlib.max_clique(clique_src, clique_tar, noise_bound)
        if len(clique) >= 3:
            T_gnc, _ = geomlib.gnc_tls(clique_src[clique], clique_tar[clique],
                                       noise_bound)
            if T_gnc is not None:
                T = T_gnc

    # ICP refinement at the noise bound (ref: teaser_fpfh_icp.py:85-89)
    T_icp, _, _ = geomlib.icp(src_down, tar_down, max_corr_dist=noise_bound,
                              init=T, max_iter=100)
    # degenerate-solve guard: a failed solve must still return a valid rigid
    # transform (the reference can crash downstream on a singular matrix)
    if not np.isfinite(T_icp).all() or abs(np.linalg.det(T_icp[:3, :3]) - 1.0) > 0.1:
        T_icp = T if (np.isfinite(T).all()
                      and abs(np.linalg.det(T[:3, :3]) - 1.0) <= 0.1) else np.eye(4)
    return T_icp[:3, :3], T_icp[:3, 3:4]



class BatchTeaser:
    """Batch variant over multi-init targets (ref: TEASER_FPFH_ICP,
    teaser_fpfh_icp.py:122-171): teaser_fpfh_icp of one source onto each
    target in turn, one generator carried across the targets."""

    def __init__(self, source_points: np.ndarray, voxel_size: float = 0.05,
                 spc: bool = False, seed: int = 0):
        self.source = np.asarray(source_points)
        self.voxel_size = voxel_size
        self.spc = spc
        self.rng = np.random.default_rng(seed)

    def forward(self, target_batch: list[np.ndarray]):
        """(R [n, 3, 3], t [n, 3, 1]), one pair a target."""
        Rs, ts = [], []
        for tar in target_batch:
            R, t = teaser_fpfh_icp(self.source, tar, self.voxel_size,
                                   self.spc, self.rng)
            Rs.append(R)
            ts.append(t)
        return np.stack(Rs), np.stack(ts)
