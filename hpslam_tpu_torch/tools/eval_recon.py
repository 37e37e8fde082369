"""Reconstruction evaluation (port of hpslam_tpu/tools/eval_recon.py,
reference src/tools/eval_recon.py).

3D metrics: accuracy / completion / completion ratio (< 5 cm) over sampled
mesh surface points, plus precision / recall / F-score at a distance
threshold, on the port's native kd-tree; optional ICP pre-alignment.
2D metric (``eval_depth_l1``): depth L1 over random virtual views rendered
from both meshes with the native BVH raycaster, with unseen-region
rejection sampling.

    python -m hpslam_tpu_torch.tools.eval_recon REC.ply GT.ply \
        [-2d --bound xmin xmax ymin ymax zmin zmax]
"""
from __future__ import annotations

import argparse

import numpy as np


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Uniform area-weighted surface sampling."""
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    p = areas / max(areas.sum(), 1e-12)
    fi = rng.choice(len(faces), size=n, p=p)
    r1 = np.sqrt(rng.uniform(size=n))
    r2 = rng.uniform(size=n)
    a, b, c = v0[fi], v1[fi], v2[fi]
    return ((1 - r1)[:, None] * a + (r1 * (1 - r2))[:, None] * b
            + (r1 * r2)[:, None] * c).astype(np.float32)


def _nn_dist(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    from ..native import KDTree
    tree = KDTree(dst)
    _idx, d2 = tree.nearest(src)
    return np.sqrt(d2)


def icp_prealign(rec_pts: np.ndarray, gt_pts: np.ndarray,
                 threshold: float = 0.1) -> np.ndarray:
    from ..native import estimate_normals, icp_point_to_plane
    normals = estimate_normals(gt_pts, k=30)
    T, fit, _ = icp_point_to_plane(rec_pts, gt_pts, normals,
                                   max_corr_dist=threshold, max_iter=100)
    return T


def recon_metrics(rec_pts: np.ndarray, gt_pts: np.ndarray,
                  dist_thresh: float = 0.05,
                  fscore_thresh: float = 0.01) -> dict:
    acc_d = _nn_dist(rec_pts, gt_pts)      # rec -> gt
    comp_d = _nn_dist(gt_pts, rec_pts)     # gt -> rec
    precision = float((acc_d < fscore_thresh).mean())
    recall = float((comp_d < fscore_thresh).mean())
    f = 2 * precision * recall / max(precision + recall, 1e-12)
    return {
        "accuracy_cm": float(acc_d.mean() * 100),
        "completion_cm": float(comp_d.mean() * 100),
        "completion_ratio_<5cm_%": float((comp_d < dist_thresh).mean() * 100),
        "precision": precision,
        "recall": recall,
        "fscore": f,
    }


def eval_recon_3d(rec_mesh_path: str, gt_mesh_path: str,
                  n_samples: int = 200_000, align: bool = True,
                  seed: int = 1219) -> dict:
    from ..utils.ply import read_ply
    rng = np.random.default_rng(seed)
    rv, _rc, rf = read_ply(rec_mesh_path)
    gv, _gc, gf = read_ply(gt_mesh_path)
    rec = sample_surface(rv, rf, n_samples, rng) if rf is not None else rv
    gt = sample_surface(gv, gf, n_samples, rng) if gf is not None else gv
    if align:
        T = icp_prealign(rec, gt)
        rec = rec @ T[:3, :3].T + T[:3, 3]
    return recon_metrics(rec, gt)


def eval_depth_l1(rec_mesh_path: str, gt_mesh_path: str, bound,
                  n_views: int = 1000, H: int = 240, W: int = 320,
                  fx: float = 200.0, seed: int = 1219,
                  unseen_reject: bool = True) -> dict:
    """Depth-L1 over random virtual views (eval_recon.py:138-220): sample
    camera poses inside the scene bound, raycast both meshes, compare depth
    where both hit; views seeing mostly unseen regions in the reconstruction
    are rejected and resampled."""
    from ..native import MeshRaycaster
    from ..utils.ply import read_ply
    rng = np.random.default_rng(seed)
    rv, _rc, rf = read_ply(rec_mesh_path)
    gv, _gc, gf = read_ply(gt_mesh_path)
    rc_gt = MeshRaycaster(gv, gf)
    rc_rec = MeshRaycaster(rv, rf)
    bound = np.asarray(bound, np.float64)
    cx, cy = (W - 1) / 2, (H - 1) / 2

    total_l1, used = 0.0, 0
    attempts = 0
    while used < n_views and attempts < 4 * n_views:
        attempts += 1
        pos = np.array([rng.uniform(*bound[a]) for a in range(3)])
        yaw = rng.uniform(0, 2 * np.pi)
        pitch = rng.uniform(-0.4, 0.4)
        cyw, syw = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        R = np.array([[cyw, 0, syw], [0, 1, 0], [-syw, 0, cyw]]) @ \
            np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        jj, ii = np.mgrid[0:H, 0:W]
        dirs = np.stack([(ii - cx) / fx, (jj - cy) / fx,
                         np.ones_like(ii, float)], -1)
        rd = (dirs @ R.T).astype(np.float32).reshape(-1, 3)
        ro = np.broadcast_to(pos, rd.shape).astype(np.float32)
        d_gt = rc_gt.cast(ro, rd)
        d_rec = rc_rec.cast(ro, rd)
        hit_gt = d_gt > 0
        if hit_gt.mean() < 0.5:
            continue  # camera inside a wall / outside scene
        hit_both = hit_gt & (d_rec > 0)
        if unseen_reject and hit_both.sum() < 0.3 * hit_gt.sum():
            continue
        if hit_both.sum() == 0:
            continue
        total_l1 += float(np.abs(d_gt[hit_both] - d_rec[hit_both]).mean())
        used += 1
    return {"depth_l1_cm": 100.0 * total_l1 / max(used, 1), "views": used}


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate reconstruction.")
    p.add_argument("rec_mesh", type=str)
    p.add_argument("gt_mesh", type=str)
    p.add_argument("-3d", "--three_d", action="store_true", default=True)
    p.add_argument("-2d", "--two_d", action="store_true")
    p.add_argument("--bound", type=float, nargs=6, default=None,
                   help="xmin xmax ymin ymax zmin zmax for virtual views")
    p.add_argument("--n_views", type=int, default=1000)
    args = p.parse_args(argv)

    out = eval_recon_3d(args.rec_mesh, args.gt_mesh)
    if args.two_d and args.bound:
        b = np.array(args.bound).reshape(3, 2)
        out.update(eval_depth_l1(args.rec_mesh, args.gt_mesh, b,
                                 n_views=args.n_views))
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
