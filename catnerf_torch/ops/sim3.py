"""sim(3) pose conversion (numpy), the part of the JAX package's
`ops/sim3.py` that the scene build, the checkpoints, the mesher and the
registration need (ref: src/utils.py:361-491)."""

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


def quat_to_rotation_np(q: np.ndarray) -> np.ndarray:
    """Quaternion [w, x, y, z] -> rotation matrix (ref: src/utils.py:468-491)."""
    qr, qi, qj, qk = q
    two_s = 2.0 / float(np.dot(q, q))
    return np.array(
        [
            [1 - two_s * (qj * qj + qk * qk), two_s * (qi * qj - qk * qr), two_s * (qi * qk + qj * qr)],
            [two_s * (qi * qj + qk * qr), 1 - two_s * (qi * qi + qk * qk), two_s * (qj * qk - qi * qr)],
            [two_s * (qi * qk - qj * qr), two_s * (qj * qk + qi * qr), 1 - two_s * (qi * qi + qj * qj)],
        ]
    )


def tensor_to_sim3_np(t: np.ndarray) -> np.ndarray:
    """[s, qw..qz, t] -> 4x4 sim(3) matrix (ref: src/utils.py:432-447)."""
    t = np.asarray(t, dtype=np.float64)
    s, q, trans = t[0], t[1:5], t[5:8]
    T = np.eye(4)
    T[:3, :3] = quat_to_rotation_np(q) * s
    T[:3, 3] = trans
    return T.astype(np.float32)


def tensor_to_se3_np(t: np.ndarray) -> np.ndarray:
    """[qw..qz, t] (7-vector) -> 4x4 rigid transform (ref: src/utils.py:411-430)."""
    t = np.asarray(t, dtype=np.float64)
    q, trans = t[:4], t[4:7]
    T = np.eye(4)
    T[:3, :3] = quat_to_rotation_np(q)
    T[:3, 3] = trans
    return T.astype(np.float32)


def transform_pointcloud_np(points: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Apply homogeneous transform to (N, 3) points (ref: src/utils.py:361-366)."""
    return points @ T[:3, :3].T + T[:3, 3]
