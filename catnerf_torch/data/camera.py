"""Camera ray-direction cache.

A numpy copy of the JAX package's module of the same name.

Parity target: `cameraInfo` (ref: src/scene_cateogries.py:600-629). The whole
pipeline uses the reference's transposed (W, H) image convention: axis 0 is
image x / width, axis 1 is image y / height (the reference transposes every
loaded image, src/dataset.py:105-109). Ray dirs use the z-depth convention:
dir = ((x - cx)/fx, (y - cy)/fy, 1), so depth values multiply dirs directly.
"""

from __future__ import annotations

import numpy as np


def ray_dirs_cache(width: int, height: int, fx: float, fy: float,
                   cx: float, cy: float) -> np.ndarray:
    """(W, H, 3) per-pixel camera-frame ray directions with z = 1."""
    idx_w = np.arange(width, dtype=np.float32)
    idx_h = np.arange(height, dtype=np.float32)
    dirs = np.ones((width, height, 3), dtype=np.float32)
    dirs[:, :, 0] = ((idx_w - cx) / fx)[:, None]
    dirs[:, :, 1] = ((idx_h - cy) / fy)[None, :]
    return dirs


class CameraInfo:
    """Pinhole camera + cached ray dirs (ref: src/scene_cateogries.py:600-611)."""

    def __init__(self, width: int, height: int, fx: float, fy: float,
                 cx: float, cy: float):
        self.width = width
        self.height = height
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.rays_dir_cache = ray_dirs_cache(width, height, fx, fy, cx, cy)

    @classmethod
    def from_config(cls, cfg) -> "CameraInfo":
        return cls(cfg.W_frame, cfg.H_frame, cfg.fx, cfg.fy, cfg.cx_eff, cfg.cy_eff)

    @property
    def K(self) -> np.ndarray:
        K = np.eye(3)
        K[0, 0], K[1, 1] = self.fx, self.fy
        K[0, 2], K[1, 2] = self.cx, self.cy
        return K

    def unproject_depth(self, depth_wh: np.ndarray, T_WC: np.ndarray | None = None
                        ) -> np.ndarray:
        """Depth map (W, H) -> (N, 3) world/camera-frame points for valid
        (depth > 0) pixels. Replaces Open3D create_from_depth_image
        (ref: src/utils.py:329-339)."""
        valid = depth_wh > 0
        pts_c = self.rays_dir_cache[valid] * depth_wh[valid][:, None]
        if T_WC is None:
            return pts_c
        return pts_c @ T_WC[:3, :3].T + T_WC[:3, 3]
