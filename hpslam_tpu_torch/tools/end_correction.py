"""End-of-trajectory drift correction (port of
hpslam_tpu/tools/end_correction.py, reference Mapper.py:1080-1148).

The trajectory-tail input cloud is registered against the earlier map by
FPFH + RANSAC global registration and coarse-to-fine point-to-plane ICP on
the port's native runtime (``hpslam_tpu_torch.native``); an exponentially
decayed translation correction is then applied to the last ``0.4*n_img``
poses with interval ``0.5*n_img`` (the reference's 800 / 1000 at its
~2000-frame scale).  The ICP schedule and the proportional window are the
JAX package's deviations from the reference, kept as they are.

Gates: ``mapping.end_corr_min_pts`` (50 000 input points) and
``mapping.end_corr_min_fitness`` (0.5).  A gate's rejection is a normal
"not applied".  Deliberate deviation from the JAX package, which catches
every exception here: a failure to build or load the native library
raises.
"""
from __future__ import annotations

import numpy as np


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """The first point of each occupied voxel, in input order."""
    keys = np.floor(points / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(idx)]


def register_tail(cloud: np.ndarray, cam_pos: np.ndarray,
                  voxel_size: float = 0.04, min_pts: int = 50_000):
    """Align the trajectory-tail cloud onto the earlier map.

    Returns (T 4x4, fitness) or (None, 0)."""
    from ..native import (estimate_normals, fpfh_ransac_register,
                          icp_point_to_plane)

    n = cloud.shape[0]
    if n <= min_pts:
        return None, 0.0
    vp = cam_pos.astype(np.float32)
    target = voxel_downsample(cloud[: int(n * 0.6)], voxel_size)
    normals = estimate_normals(target, k=30, viewpoint=vp)

    best_T, best_fit, best_rmse = None, 0.0, np.inf
    for coef in (0.8, 0.9, 0.95):
        source = voxel_downsample(cloud[int(n * coef):], voxel_size)
        if source.shape[0] < 100:
            continue
        # global stage: feature radius 5 x voxel, RANSAC distance 1.5 x voxel
        src_normals = estimate_normals(source, k=30, viewpoint=vp)
        T_global, fit_global = fpfh_ransac_register(
            source, src_normals, target, normals,
            feature_radius=5.0 * voxel_size,
            max_corr_dist=1.5 * voxel_size)
        inits = [np.eye(4, dtype=np.float32)]
        if fit_global > 0.3:
            inits.insert(0, T_global)
        for T0 in inits:
            # coarse-to-fine point-to-plane ICP
            T = np.asarray(T0, np.float32)
            for d in (0.5, 0.25, 0.12, 0.06, voxel_size):
                T, fit, rmse = icp_point_to_plane(
                    source, target, normals, max_corr_dist=max(d, voxel_size),
                    max_iter=200, init=T)
            if fit > best_fit or (fit == best_fit and rmse < best_rmse):
                best_T, best_fit, best_rmse = T, fit, rmse
    return best_T, best_fit


def apply_end_correction(slam) -> dict:
    """Correct slam.estimate_c2w_list in place.  Returns the outcome:
    {"applied", "fitness", "translation" (3 floats or None), "input_pts"}."""
    mcfg = slam.cfg["mapping"]
    min_pts = int(mcfg.get("end_corr_min_pts", 50_000))
    min_fitness = float(mcfg.get("end_corr_min_fitness", 0.5))
    cloud = np.asarray(slam.npc.input_pos(), np.float32).reshape(-1, 3)
    out = {"applied": False, "fitness": 0.0, "translation": None,
           "input_pts": int(cloud.shape[0])}
    idx = slam.n_img - 1
    cur_c2w = slam.estimate_c2w_list[idx].copy()
    if cloud.shape[0] <= min_pts:
        print(f"npc_pts_num: {cloud.shape[0]}; end correction rejected.")
        return out
    T, fitness = register_tail(cloud, cur_c2w[:3, 3], min_pts=min_pts)
    out["fitness"] = float(fitness)
    if T is None or fitness <= min_fitness:
        print(f"result_fitness: {fitness}; end correction rejected.")
        return out
    print("correction transformation:\n", T)
    new_c2w = T @ cur_c2w
    translation = new_c2w[:3, 3] - cur_c2w[:3, 3]
    print("end translation correction:", translation)
    slam.estimate_c2w_list[idx] = new_c2w
    # proportional decay window (see the module docstring)
    window = max(1, int(round(0.4 * slam.n_img)))
    index_interval = 0.5 * slam.n_img
    for i in range(idx):
        if i >= idx - window:
            decay = np.exp(-abs(i - idx) / index_interval)
            slam.estimate_c2w_list[i][:3, 3] += translation * decay
    out["applied"] = True
    out["translation"] = [float(v) for v in translation]
    return out
