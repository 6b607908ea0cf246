"""Per-instance point-cloud accumulation (registration stage 1): a copy
of the JAX package's `geometry/pointcloud.py` on the port's geometry
library.

Parity target: `accumulate_pointcloud` (ref: src/utils.py:189-210) —
Replica: direct unprojection + voxel downsample, with the first-party C++
kernels instead of Open3D. The ScanNet route (TSDF fusion,
`accumulate_pointcloud_tsdf`, ref: src/utils.py:212-247) is not ported yet
(ROADMAP.md Queue 1).
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
