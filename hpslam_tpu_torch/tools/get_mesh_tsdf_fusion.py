"""Offline meshing: re-render the estimated trajectory and TSDF-fuse it
(port of hpslam_tpu/tools/get_mesh_tsdf_fusion.py, reference
src/tools/get_mesh_tsdf_fusion.py).

Every ``render_every``-th frame is rendered along the estimated trajectory
by ``utils.visualizer.render_img`` on the run's device (one host copy per
frame), and integrated on the host into the native block-sparse TSDF
(voxel 5/512 m, sdf_trunc 0.04), whose marching-tetrahedra extraction
gives the mesh.  The query-radius maps are recomputed from each frame's
colour image (they are a deterministic function of it).  The reference's
constant "compensate vector" added to every camera centre (a bias of
Open3D's volume) stays omitted, as in the JAX package.

    python -m hpslam_tpu_torch.tools.get_mesh_tsdf_fusion CONFIG \
        --output RUN_DIR [--device cpu] [--render_every 5] [--no_render]

The run is restored from RUN_DIR's latest checkpoint through
``PointSLAM.restore_from``.  Writes ``RUN_DIR/mesh/final_mesh{_name}.ply``
and, beside it, a JSON file with the mesh's size and the render's and the
fusion's seconds; with ``meshing.gt_mesh_path`` in the config, evaluates
the mesh against it (``tools.eval_recon``).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def fuse_trajectory(slam_like, params, npc, reader, estimate_c2w_list,
                    n_img: int, render_every: int = 5,
                    voxel_size: float = 5.0 / 512, sdf_trunc: float = 0.04,
                    depth_trunc: float = 8.0, level: str = "fine",
                    use_gt_depth: bool = False, verbose: bool = True,
                    timing: dict = None):
    """Integrate rendered (or input) depth / colour maps into a TSDF mesh.
    Returns (verts, colours, faces); ``timing`` (a dict), where given,
    gets the render's and the fusion's seconds and the frame count."""
    import torch

    from ..native import TSDFVolume
    from ..ops.image import dynamic_radii
    from ..renderer import RenderConfig
    from ..utils.visualizer import render_img

    s = slam_like
    vol = TSDFVolume(voxel_size, sdf_trunc)
    intr = (s.fx, s.fy, s.cx, s.cy)
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    rcfg = RenderConfig.from_cfg(s.cfg, "sigmoid_coef_mapper")
    lv = npc.levels[level]
    pc = s.cfg["pointcloud"]
    t_render = t_fuse = 0.0
    frames = 0
    for idx in range(0, n_img, render_every):
        frame = reader[idx]
        c2w = estimate_c2w_list[idx]
        if not np.isfinite(c2w).all():
            continue
        t0 = time.perf_counter()
        if use_gt_depth:
            depth, color = frame.depth, frame.color
        else:
            _, r_query = dynamic_radii(frame.color, pc["radius_hierarchy"],
                                       pc["radius_query_ratio"],
                                       pc["color_grad_threshold"])
            d, _unc, c = render_img(
                params, s.mcfg, rcfg, c2w, s.H, s.W, s.fx, s.fy, s.cx, s.cy,
                (lv.pos, lv.count, lv.geo, lv.col), r_query[level],
                gt_depth=frame.depth, stage=f"color_{level}")
            depth = d.cpu().numpy()
            color = torch.clamp(c, 0.0, 1.0).cpu().numpy()
        t1 = time.perf_counter()
        # -z-forward -> the CV convention of the TSDF integrator
        w2c_cv = np.linalg.inv(c2w @ flip)
        vol.integrate(np.asarray(depth, np.float32),
                      np.asarray(color, np.float32), intr,
                      w2c_cv.astype(np.float32), depth_trunc)
        t_render += t1 - t0
        t_fuse += time.perf_counter() - t1
        frames += 1
        if verbose and idx % (render_every * 20) == 0:
            print(f"fused frame {idx}/{n_img}", flush=True)
    t0 = time.perf_counter()
    mesh = vol.extract_mesh()
    if timing is not None:
        timing.update(render_s=t_render, fuse_s=t_fuse,
                      extract_s=time.perf_counter() - t0, frames=frames)
    return mesh


def main(argv=None):
    from .. import config as C
    from ..slam import PointSLAM
    from ..utils.logger import latest_checkpoint
    from ..utils.ply import write_ply_mesh

    p = C.build_arg_parser(description="TSDF-fusion meshing.")
    p.add_argument("--name", type=str, default=None,
                   help="suffix for the output mesh filename")
    p.add_argument("--no_render", action="store_true",
                   help="integrate the input depth instead of the rendered")
    p.add_argument("--no_eval", action="store_true")
    p.add_argument("-s", "--silent", action="store_true")
    p.add_argument("--mid_mesh", action="store_true",
                   help="also extract a mesh from the mid level")
    p.add_argument("--render_every", type=int, default=5)
    p.add_argument("--voxel_size", type=float, default=5.0 / 512)
    args = p.parse_args(argv)

    cfg = C.apply_args(C.load_config(args.config, C.default_config_path()),
                       args)
    cfg["resume"] = False
    cfg["verbose"] = not args.silent
    output = cfg["data"]["output"]
    ck = latest_checkpoint(output)
    if ck is None:
        print("no checkpoint under", output)
        return 1
    slam = PointSLAM(cfg, device=args.device)
    n_img = slam.restore_from(ck) + 1
    verbose = not args.silent
    suffix = f"_{args.name}" if args.name else ""
    os.makedirs(os.path.join(output, "mesh"), exist_ok=True)
    for level, stem in (("fine", "final_mesh"), ("mid", "mid_mesh")):
        if level == "mid" and not args.mid_mesh:
            break
        timing: dict = {}
        verts, cols, faces = fuse_trajectory(
            slam, slam.params, slam.npc, slam.frame_reader,
            slam.estimate_c2w_list, n_img, render_every=args.render_every,
            voxel_size=args.voxel_size, use_gt_depth=args.no_render,
            level=level, verbose=verbose, timing=timing)
        mesh_path = os.path.join(output, "mesh", f"{stem}{suffix}.ply")
        write_ply_mesh(mesh_path, verts, faces, cols)
        stats = {"mesh": mesh_path, "verts": int(verts.shape[0]),
                 "faces": int(faces.shape[0]), "device": slam.device.type,
                 "checkpoint": ck, **timing}
        with open(mesh_path[:-len(".ply")] + ".json", "w") as f:
            json.dump(stats, f, indent=1)
        if verbose:
            print(json.dumps(stats), flush=True)
        if level == "fine":
            fine_path = mesh_path
    if not args.no_eval:
        gt_mesh = cfg.get("meshing", {}).get("gt_mesh_path")
        if gt_mesh and os.path.exists(gt_mesh):
            from .eval_recon import eval_recon_3d
            print(eval_recon_3d(fine_path, gt_mesh), flush=True)
        elif verbose:
            print("no gt mesh configured (meshing.gt_mesh_path); skipping "
                  "the reconstruction eval", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
