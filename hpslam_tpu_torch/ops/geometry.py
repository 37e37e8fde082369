"""Camera / ray / rigid-transform primitives (port of hpslam_tpu/ops/geometry.py).

Conventions as in the reference: pixel (i, j) = (column, row), camera-frame
ray direction ((i-cx)/fx, -(j-cy)/fy, -1); camera tensors are 7-vectors
[qw qx qy qz tx ty tz].  The torch functions are differentiable where the
reference's are (pose gradients through quad2rotation); the numpy twins
serve host-side per-frame bookkeeping.
"""
from __future__ import annotations

import numpy as np
import torch


def as_intrinsics_matrix(intrinsics) -> np.ndarray:
    """(fx, fy, cx, cy) -> 3x3 K matrix (float64 numpy, as the reference)."""
    fx, fy, cx, cy = intrinsics
    K = np.eye(3)
    K[0, 0] = fx
    K[1, 1] = fy
    K[0, 2] = cx
    K[1, 2] = cy
    return K


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


def get_rays(H: int, W: int, fx, fy, cx, cy, c2w, device=None):
    """Full-image ray grid: (rays_o, rays_d), each (H, W, 3)."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=c2w.device),
        torch.arange(W, dtype=torch.float32, device=c2w.device),
        indexing="ij")
    rays_d = camera_dirs(i, j, fx, fy, cx, cy) @ c2w[:3, :3].T
    return c2w[:3, 3].expand_as(rays_d), rays_d


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


def rotation2quad(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion wxyz (Shepperd's method,
    branch-free): the four constructions, the one of the largest of (trace,
    m00, m11, m22) taken (the first on a tie), normalised, qw >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(a):
        return torch.sqrt(torch.clamp(a, min=1e-12)) / 2
    qw0 = root(1 + tr)
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    qx1 = root(1 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], -1)
    qy2 = root(1 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], -1)
    qz3 = root(1 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], -1)
    cand = torch.stack([q0, q1, q2, q3], dim=-2)          # (..., 4, 4)
    best = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)
    q = torch.gather(cand, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def get_tensor_from_camera(RT, Tquad: bool = False) -> torch.Tensor:
    """3x4 / 4x4 c2w -> 7-vector [q, T] (or [T, q] with Tquad)."""
    RT = torch.as_tensor(RT)
    quad, T = rotation2quad(RT[:3, :3]), RT[:3, 3]
    return torch.cat([T, quad]) if Tquad else torch.cat([quad, T])


def c2w_to_44(c2w34: torch.Tensor) -> torch.Tensor:
    """Append the homogeneous bottom row to a 3x4 pose."""
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=c2w34.dtype,
                          device=c2w34.device)
    return torch.cat([c2w34, bottom], dim=0)


def transform_points(T44: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform to (N, 3) points."""
    return pts @ T44[:3, :3].T + T44[:3, 3]


def cart2sph(xyz: torch.Tensor) -> torch.Tensor:
    """Unit normals (N, 3) -> (inclination, azimuth) (N, 2)."""
    xy = xyz[:, 0] ** 2 + xyz[:, 1] ** 2
    theta = torch.atan2(torch.sqrt(xy), xyz[:, 2])
    phi = torch.atan2(xyz[:, 1], xyz[:, 0])
    return torch.stack([theta, phi], -1)


def masked_psnr(img1, img2, mask) -> torch.Tensor:
    """PSNR over the pixels where ``mask`` is true (100 where they agree)."""
    mse = torch.mean((img1[mask] - img2[mask]) ** 2)
    return torch.where(mse == 0, torch.full_like(mse, 100.0),
                       -10.0 * torch.log10(mse))


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
