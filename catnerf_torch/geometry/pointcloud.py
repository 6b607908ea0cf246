"""Per-instance point-cloud accumulation (registration stage 1): a copy
of the JAX package's `geometry/pointcloud.py` on the port's geometry
library.

Parity targets: `accumulate_pointcloud` / `accumulate_pointcloud_tsdf`
(ref: src/utils.py:189-247) — Replica: direct unprojection + voxel
downsample; noisy real-world depth (ScanNet, `/ingest`'s
`accumulate=tsdf`): TSDF fusion + radius outlier removal. Uses the
first-party C++ kernels instead of Open3D.
"""

from __future__ import annotations

import numpy as np

from catnerf_torch.data.camera import CameraInfo
from catnerf_torch.native.lib import geomlib


def accumulate_pointcloud(inst_id: int, inst_info_list: list[dict],
                          frame_samples: dict, cam: CameraInfo,
                          voxel_size: float = 0.01) -> np.ndarray:
    """World-frame cloud of one instance across its frames
    (ref: src/utils.py:189-210)."""
    clouds = []
    for info in inst_info_list:
        sample = frame_samples[info["frame"]]
        assert info["frame"] == sample["frame_id"]
        mask = sample["obj_mask"] == inst_id
        depth = np.where(mask, sample["depth"], 0.0)
        T_WC = np.asarray(sample["T"], np.float64)
        clouds.append(cam.unproject_depth(depth, T_WC))
    pts = np.concatenate(clouds) if clouds else np.zeros((0, 3))
    if len(pts) == 0:
        return pts.astype(np.float32)
    return geomlib.voxel_downsample(pts.astype(np.float32), voxel_size)


def accumulate_pointcloud_tsdf(inst_id: int, inst_info_list: list[dict],
                               frame_samples: dict, cam: CameraInfo,
                               voxel_size: float = 0.01,
                               max_depth: float = 6.0) -> np.ndarray:
    """TSDF-fused cloud for noisy real-world depth
    (ref: src/utils.py:212-247): voxel 1 cm, trunc 4 voxels, followed by
    voxel downsample + radius outlier removal (100 pts / 5 cm)."""
    vol = geomlib.TSDFVolume(voxel_length=voxel_size,
                             sdf_trunc=4 * voxel_size)
    for info in inst_info_list:
        sample = frame_samples[info["frame"]]
        assert info["frame"] == sample["frame_id"]
        mask = sample["obj_mask"] == inst_id
        depth = np.where(mask, sample["depth"], 0.0).astype(np.float32)
        T_CW = np.linalg.inv(np.asarray(sample["T"], np.float64))
        vol.integrate(depth, sample["image"], cam.fx, cam.fy, cam.cx, cam.cy,
                      T_CW, max_depth=max_depth)
    pts, _ = vol.extract_point_cloud()
    if len(pts) == 0:
        return pts
    pts = geomlib.voxel_downsample(pts, voxel_size)
    kept, _ = geomlib.remove_radius_outliers(pts, nb_points=100, radius=0.05)
    if len(kept) < 100:
        print("too few points left after outlier rejection")
        return pts
    return kept


def colorize_pointcloud(pcs: np.ndarray, inst_id: int,
                        inst_info_list: list[dict], frame_samples: dict,
                        cam: CameraInfo) -> np.ndarray | None:
    """Per-point RGB (float32 in [0,1]) for an accumulated cloud, by
    nearest-neighbour transfer from the instance's unprojected masked
    pixels. Works for any `pcs` provenance (direct unprojection OR TSDF
    fusion): the observation cloud is rebuilt here and colors ride its
    raster order, so `pcs` itself stays bit-identical to the geometric
    pipeline. Beyond-reference capability: the reference's registration is
    geometry-only (ref: src/category_registration.py:257-267), which
    cannot disambiguate near-symmetric shapes — the appearance-aware
    candidate tie-break (geometry/registration.py) consumes these colors.
    Returns None when the instance has no valid masked pixels."""
    pts_all, cols_all = [], []
    for info in inst_info_list:
        sample = frame_samples[info["frame"]]
        mask = sample["obj_mask"] == inst_id
        depth = np.where(mask, sample["depth"], 0.0)
        valid = depth > 0
        if not valid.any():
            continue
        pts_all.append(cam.unproject_depth(
            depth, np.asarray(sample["T"], np.float64)))
        cols_all.append(np.asarray(sample["image"], np.float32)[valid]
                        / 255.0)
    if not pts_all:
        return None
    pts = np.concatenate(pts_all).astype(np.float32)
    cols = np.concatenate(cols_all)
    tree = geomlib.KDTree(pts)
    _, idx = tree.query(np.asarray(pcs, np.float32))
    return cols[idx]


def chamfer_unidirectional(src: np.ndarray, dst: np.ndarray) -> float:
    """Mean NN distance src->dst (open3d compute_point_cloud_distance,
    ref: src/category_registration.py:262)."""
    tree = geomlib.KDTree(dst.astype(np.float32))
    dist, _ = tree.query(src.astype(np.float32))
    return float(dist.mean())
