"""Ground-truth mesh of the synthetic cube room (port of
hpslam_tpu/tools/make_synth_gt_mesh.py).

The synthetic dataset (utils/datasets.Synthetic) ray-casts an axis-aligned
box of half-size 2.5 m; its surface is exactly that box's interior.  The
tool writes it subdivided and triangulated, so that eval_recon's surface
sampling and culling behave as on a scanned mesh:

    python -m hpslam_tpu_torch.tools.make_synth_gt_mesh OUT.ply
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def box_mesh(half: float = 2.5, res: int = 40):
    """Subdivided axis-aligned box surface; returns (verts, faces)."""
    verts, faces = [], []
    g = np.linspace(-half, half, res + 1)
    for axis in range(3):
        for side in (-half, half):
            uu, vv = np.meshgrid(g, g, indexing="ij")
            pts = np.zeros(((res + 1) ** 2, 3), np.float32)
            other = [a for a in range(3) if a != axis]
            pts[:, other[0]] = uu.ravel()
            pts[:, other[1]] = vv.ravel()
            pts[:, axis] = side
            base = sum(v.shape[0] for v in verts)
            verts.append(pts)
            ii, jj = np.meshgrid(np.arange(res), np.arange(res),
                                 indexing="ij")
            v00 = base + ii * (res + 1) + jj
            v01 = v00 + 1
            v10 = v00 + (res + 1)
            v11 = v10 + 1
            f = np.stack([np.stack([v00, v10, v01], -1),
                          np.stack([v01, v10, v11], -1)], 1).reshape(-1, 3)
            faces.append(f)
    return (np.concatenate(verts, 0).astype(np.float32),
            np.concatenate(faces, 0).astype(np.int32))


def main(argv=None):
    p = argparse.ArgumentParser(description="Synthetic GT box mesh.")
    p.add_argument("out", type=str)
    p.add_argument("--half", type=float, default=2.5)
    p.add_argument("--res", type=int, default=40)
    args = p.parse_args(argv)
    from ..utils.ply import write_ply_mesh
    v, f = box_mesh(args.half, args.res)
    write_ply_mesh(args.out, v, f, None)
    print(f"wrote {args.out}: {v.shape[0]} verts, {f.shape[0]} faces")
    return 0


if __name__ == "__main__":
    sys.exit(main())
