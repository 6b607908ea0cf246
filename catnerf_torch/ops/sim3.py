"""sim(3) pose conversion: the JAX package's `ops/sim3.py`, in numpy
(what the scene build, the checkpoints, the mesher and the registration
need, ref: src/utils.py:361-491) and in batched torch (its jax.numpy
functions, :104-170)."""

from __future__ import annotations

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# torch, batched over leading dims
# ---------------------------------------------------------------------------

def _homogeneous(top: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] -> [..., 4, 4] with the row [0, 0, 0, 1] below."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def quat_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """Batched quaternion [..., 4] (wxyz) -> rotation [..., 3, 3]."""
    qr, qi, qj, qk = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    rows = ((1 - two_s * (qj**2 + qk**2), two_s * (qi * qj - qk * qr),
             two_s * (qi * qk + qj * qr)),
            (two_s * (qi * qj + qk * qr), 1 - two_s * (qi**2 + qk**2),
             two_s * (qj * qk - qi * qr)),
            (two_s * (qi * qk - qj * qr), two_s * (qj * qk + qi * qr),
             1 - two_s * (qi**2 + qj**2)))
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def tensor_to_sim3(t: torch.Tensor) -> torch.Tensor:
    """Batched [..., 8] sim(3) tensor [s, qw..qz, t] -> [..., 4, 4]."""
    R = quat_to_rotation(t[..., 1:5]) * t[..., 0, None, None]
    return _homogeneous(torch.cat([R, t[..., 5:8, None]], dim=-1))


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a batched rigid transform [..., 4, 4]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    return _homogeneous(torch.cat([Rt, ti[..., None]], dim=-1))


def origin_dirs_world(T_WC: torch.Tensor, dirs_C: torch.Tensor):
    """Camera-frame ray dirs -> world frame (ref:
    src/scene_cateogries.py:37-47). T_WC [N, 4, 4], dirs_C [N, 3] ->
    (origins [N, 3], dirs [N, 3])."""
    dirs_W = torch.einsum("nij,nj->ni", T_WC[:, :3, :3], dirs_C)
    return T_WC[:, :3, 3], dirs_W


def origin_dirs_object(T_CO: torch.Tensor, dirs_C: torch.Tensor):
    """Camera-frame ray dirs -> the canonical object frame through
    inv(T_CO) (ref: src/scene_cateogries.py:24-35): T_CO carries a sim(3)
    scale, so the general inverse, whose 1/s normalises the object
    frame."""
    T_OC = torch.linalg.inv(T_CO)
    dirs_O = torch.einsum("nij,nj->ni", T_OC[:, :3, :3], dirs_C)
    return T_OC[:, :3, 3], dirs_O
