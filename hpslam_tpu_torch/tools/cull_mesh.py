"""Frustum mesh culling (port of hpslam_tpu/tools/cull_mesh.py): drop the
faces whose vertices fall outside every camera frustum of the trajectory.
Intrinsics come from the config.

    python -m hpslam_tpu_torch.tools.cull_mesh CONFIG MESH.ply \
        [--output RUN_DIR] [--out_mesh OUT.ply]

The poses are those of the run's latest checkpoint (``RUN_DIR/ckpts``).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def cull(verts: np.ndarray, faces: np.ndarray, poses, H: int, W: int,
         fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    """Returns the kept faces.  ``poses`` are -z-forward c2w matrices."""
    inside_any = np.zeros(verts.shape[0], bool)
    ones = np.ones((verts.shape[0], 1))
    homo = np.concatenate([verts, ones], axis=1)
    for c2w in poses:
        if not np.isfinite(c2w).all():
            continue
        w2c = np.linalg.inv(c2w)
        cam = homo @ w2c.T
        x = -cam[:, 0]
        z = cam[:, 2]
        denom = z + 1e-8
        u = (fx * x + cx * denom) / denom
        v = (fy * cam[:, 1] + cy * denom) / denom
        inside = (z < 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        inside_any |= inside
        if inside_any.all():
            break
    keep = inside_any[faces].all(axis=1)
    return faces[keep]


def main(argv=None):
    from .. import config as C
    from ..utils.logger import latest_checkpoint, load_checkpoint
    from ..utils.ply import read_ply, write_ply_mesh

    p = argparse.ArgumentParser(description="Cull mesh by camera frustums.")
    p.add_argument("config", type=str)
    p.add_argument("mesh", type=str)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--out_mesh", type=str, default=None)
    args = p.parse_args(argv)

    cfg = C.load_config(args.config, C.default_config_path())
    output = args.output or cfg["data"]["output"]
    ck = latest_checkpoint(output)
    if ck is None:
        print("no checkpoint under", output)
        return 1
    state = load_checkpoint(ck)
    poses = state["estimate_c2w_list"][: state["idx"] + 1]

    cam = cfg["cam"]
    e = cam.get("crop_edge", 0) or 0
    H, W = cam["H"] - 2 * e, cam["W"] - 2 * e
    fx, fy = cam["fx"], cam["fy"]
    cx, cy = cam["cx"] - e, cam["cy"] - e

    verts, cols, faces = read_ply(args.mesh)
    kept = cull(verts, faces, poses, H, W, fx, fy, cx, cy)
    out = args.out_mesh or args.mesh.replace(".ply", "_culled.ply")
    write_ply_mesh(out, verts, kept, cols)
    print(f"culled {faces.shape[0] - kept.shape[0]}/{faces.shape[0]} faces "
          f"-> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
