"""Frozen copy of hpslam_tpu_torch/ops/geometry.py for the benchmark's
reference (imports nothing of the program).

Camera / ray / rigid-transform primitives (port of hpslam_tpu/ops/geometry.py).

Conventions as in the reference: pixel (i, j) = (column, row), camera-frame
ray direction ((i-cx)/fx, -(j-cy)/fy, -1); camera tensors are 7-vectors
[qw qx qy qz tx ty tz].  The torch functions are differentiable where the
reference's are (pose gradients through quad2rotation); the numpy twins
serve host-side per-frame bookkeeping.
"""
from __future__ import annotations

import numpy as np
import torch


def camera_dirs(i, j, fx, fy, cx, cy):
    """(N,) pixel columns/rows -> (N, 3) camera-frame ray directions."""
    return torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)],
                       dim=-1)


def get_rays_from_uv(i, j, c2w, fx, fy, cx, cy):
    """Rays through pixel centres; c2w is (3|4)x4.  Returns (rays_o, rays_d)
    of shape (N, 3)."""
    dirs = camera_dirs(i.float(), j.float(), fx, fy, cx, cy)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand_as(rays_d)
    return rays_o, rays_d


def quad2rotation(quad: torch.Tensor) -> torch.Tensor:
    """Quaternion (wxyz, any norm) -> rotation matrix, batched (N, 3, 3)."""
    quad = torch.atleast_2d(quad)
    qr, qi, qj, qk = quad[:, 0], quad[:, 1], quad[:, 2], quad[:, 3]
    two_s = 2.0 / torch.sum(quad * quad, dim=-1)
    r00 = 1 - two_s * (qj ** 2 + qk ** 2)
    r01 = two_s * (qi * qj - qk * qr)
    r02 = two_s * (qi * qk + qj * qr)
    r10 = two_s * (qi * qj + qk * qr)
    r11 = 1 - two_s * (qi ** 2 + qk ** 2)
    r12 = two_s * (qj * qk - qi * qr)
    r20 = two_s * (qi * qk - qj * qr)
    r21 = two_s * (qj * qk + qi * qr)
    r22 = 1 - two_s * (qi ** 2 + qj ** 2)
    return torch.stack([torch.stack([r00, r01, r02], -1),
                        torch.stack([r10, r11, r12], -1),
                        torch.stack([r20, r21, r22], -1)], dim=-2)


def get_camera_from_tensor(t: torch.Tensor) -> torch.Tensor:
    """7-vector [q, T] -> 3x4 c2w (or batched (N, 3, 4))."""
    single = t.dim() == 1
    t = torch.atleast_2d(t)
    R = quad2rotation(t[:, :4])
    RT = torch.cat([R, t[:, 4:, None]], dim=2)
    return RT[0] if single else RT


def project_points(points, w2c, fx, fy, cx, cy, flip_x: bool = True):
    """World points -> pixel coords (u, v) and camera-frame z (z < 0 in
    front); the x axis is negated before applying K."""
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    x = -cam[..., 0] if flip_x else cam[..., 0]
    y, z = cam[..., 1], cam[..., 2]
    denom = z + 1e-5
    u = (fx * x + cx * denom) / denom
    v = (fy * y + cy * denom) / denom
    return torch.stack([u, v], -1), z


# numpy twins for host-side per-frame bookkeeping

def quad2rotation_np(quad: np.ndarray) -> np.ndarray:
    quad = np.atleast_2d(np.asarray(quad, np.float64))
    qr, qi, qj, qk = quad[:, 0], quad[:, 1], quad[:, 2], quad[:, 3]
    two_s = 2.0 / np.sum(quad * quad, axis=-1)
    rot = np.empty((quad.shape[0], 3, 3))
    rot[:, 0, 0] = 1 - two_s * (qj ** 2 + qk ** 2)
    rot[:, 0, 1] = two_s * (qi * qj - qk * qr)
    rot[:, 0, 2] = two_s * (qi * qk + qj * qr)
    rot[:, 1, 0] = two_s * (qi * qj + qk * qr)
    rot[:, 1, 1] = 1 - two_s * (qi ** 2 + qk ** 2)
    rot[:, 1, 2] = two_s * (qj * qk - qi * qr)
    rot[:, 2, 0] = two_s * (qi * qk - qj * qr)
    rot[:, 2, 1] = two_s * (qj * qk + qi * qr)
    rot[:, 2, 2] = 1 - two_s * (qi ** 2 + qj ** 2)
    return rot


def rotation2quad_np(R: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation
    q = Rotation.from_matrix(np.asarray(R, np.float64)).as_quat()
    q = np.roll(q, 1, axis=-1)  # xyzw -> wxyz
    if q.ndim == 1 and q[0] < 0:
        q = -q
    elif q.ndim == 2:
        q = np.where(q[:, :1] < 0, -q, q)
    return q


def get_tensor_from_camera_np(RT, Tquad: bool = False) -> np.ndarray:
    RT = np.asarray(RT)
    quad = rotation2quad_np(RT[:3, :3])
    T = RT[:3, 3]
    out = np.concatenate([T, quad]) if Tquad else np.concatenate([quad, T])
    return out.astype(np.float32)


def get_camera_from_tensor_np(t: np.ndarray) -> np.ndarray:
    t = np.asarray(t)
    R = quad2rotation_np(t[:4])[0]
    return np.concatenate([R, t[4:, None]], axis=1).astype(np.float32)
