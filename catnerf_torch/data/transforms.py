"""Image-space transforms (ref: src/image_transforms.py:5-40): a copy of
the JAX package's `data/transforms.py` without `Undistort`, which needs
OpenCV and serves only the ScanNet loader (not ported yet)."""

from __future__ import annotations

import numpy as np


def depth_scale(depth: np.ndarray, scale: float) -> np.ndarray:
    """Raw depth units -> meters (ref: src/image_transforms.py:5-17)."""
    return depth.astype(np.float32) * scale


def depth_filter(depth: np.ndarray, max_depth: float) -> np.ndarray:
    """Zero out far depth (ref: src/image_transforms.py:20-30)."""
    out = depth.copy()
    out[out > max_depth] = 0.0
    return out


def bgr_to_rgb(image: np.ndarray) -> np.ndarray:
    """(ref: src/image_transforms.py:33-40)."""
    return image[..., ::-1].copy()
