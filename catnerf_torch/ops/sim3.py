"""sim(3) pose conversion (numpy), the part of the JAX package's
`ops/sim3.py` that the scene build needs (ref: src/utils.py:368-491)."""

from __future__ import annotations

import numpy as np


def rotation_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion [w, x, y, z] (Shepperd's method)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z], dtype=np.float64)
    return q / np.linalg.norm(q)


def sim3_to_tensor_np(T: np.ndarray) -> np.ndarray:
    """4x4 sim(3) matrix -> [s, qw, qx, qy, qz, tx, ty, tz].

    Scale is det(R_s)^(1/3) (ref: src/utils.py:398-409). Does not mutate T.
    """
    T = np.asarray(T, dtype=np.float64)
    scale = np.linalg.det(T[:3, :3]) ** (1.0 / 3.0)
    R = T[:3, :3] / scale
    q = rotation_to_quat_np(R)
    return np.concatenate([[scale], q, T[:3, 3]]).astype(np.float32)
