"""Full-frame rendering and the rendered-vs-input panels (port of
hpslam_tpu/utils/visualizer.py, reference src/utils/Visualizer.py).

``render_img`` renders a whole image under no gradient through
``renderer.render_rays`` in mapper mode, in fixed batches of rays: one tile
index per image, the far bound from the image's depth, and
``sample_near_pcl_z`` on a batch only where it holds a zero-depth ray.  The
result stays on the device; it is copied to the host once per image.

``Visualizer.vis`` writes, every ``freq`` frames and for each level, the
reference's 2x3 panel grid through ``utils.panels`` (a PNG without titles
or axes, ``{idx:05d}_{it:04d}_{level}.png``; see that module), and with
``save_rendered_image`` the fine level's colour as
``rendered_image/frame_{idx:05d}.png``.  Rendering reads the run's state
and draws from no random stream.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..ops import geometry as G
from ..ops import knn as K
from ..ops import sampling as S
from ..renderer import RenderConfig, render_rays, sample_near_pcl_z


@torch.no_grad()
def render_img(params, mcfg, rcfg: RenderConfig, c2w, H: int, W: int, fx,
               fy, cx, cy, level_arrays, r_query_map, gt_depth=None,
               exposure_feat=None, stage: str = "color_fine",
               ray_batch_size: int = 3000):
    """Full-frame depth (H, W), uncertainty (H, W) and colour (H, W, 3), on
    the device of the level's tensors.

    level_arrays: (pos, count, geo, col) of one level; r_query_map (H, W)
    and gt_depth (H, W) may be host arrays.  The pixels are padded to a
    multiple of ray_batch_size with rays (0, 0, -1) of depth 0 and the first
    pixel's query radius, as the reference pads them."""
    pos, count, geo, col = level_arrays
    dev = pos.device
    f32 = dict(dtype=torch.float32, device=dev)
    rays_o, rays_d = G.get_rays(H, W, fx, fy, cx, cy, np.asarray(c2w),
                                device=dev)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    rq = torch.as_tensor(np.asarray(r_query_map), **f32).reshape(-1)
    depth = (torch.as_tensor(np.asarray(gt_depth), **f32).reshape(-1)
             if gt_depth is not None else torch.zeros(H * W, **f32))
    expo = (torch.as_tensor(np.asarray(exposure_feat), **f32)
            if exposure_feat is not None else None)
    tile_index = K.build_tiles(pos, count)

    n = H * W
    pad = (-n) % ray_batch_size
    if pad:
        rays_o = torch.cat([rays_o, torch.zeros((pad, 3), **f32)])
        rays_d = torch.cat([rays_d, torch.tensor([[0.0, 0.0, -1.0]], **f32
                                                 ).expand(pad, 3)])
        rq = torch.cat([rq, rq[:1].expand(pad)])
        depth = torch.cat([depth, torch.zeros(pad, **f32)])
    n_batch = depth.shape[0] // ray_batch_size
    # host values once per image: the far bound and which batches hold a
    # zero-depth ray
    far = (float(S.far_bound_from_depth(depth)) if gt_depth is not None
           else 10.0)
    near_pcl = (rcfg.sample_near_pcl and
                (depth.reshape(n_batch, -1) <= 0).any(1).cpu().tolist())
    outs_d, outs_u, outs_c = [], [], []
    for b in range(n_batch):
        sl = slice(b * ray_batch_size, (b + 1) * ray_batch_size)
        ro, rd, dg, rqb = rays_o[sl], rays_d[sl], depth[sl], rq[sl]
        zd = None
        if near_pcl and near_pcl[b]:
            zd, _ = sample_near_pcl_z(ro, rd, rcfg.near_end, far,
                                      rcfg.N_surface, pos, count, rqb,
                                      rcfg.nn_num, tile_index=tile_index)
        d, u, c, _ = render_rays(params, mcfg, rcfg, stage, ro, rd, dg, pos,
                                 count, geo, col, rqb, exposure_feat=expo,
                                 far_fallback=far, zero_depth_z_vals=zd,
                                 tile_index=tile_index)
        outs_d.append(d)
        outs_u.append(u)
        outs_c.append(c)
    return (torch.cat(outs_d)[:n].reshape(H, W),
            torch.cat(outs_u)[:n].reshape(H, W),
            torch.cat(outs_c)[:n].reshape(H, W, 3))


def render_stats(gt_depth, gt_color, depth, color) -> dict:
    """Mean absolute depth residual (m) and colour PSNR (dB, colour clipped
    to [0, 1]) over the pixels of non-zero input depth (host arrays)."""
    valid = np.asarray(gt_depth) > 0
    if not valid.any():
        return {"depth_l1_m": None, "psnr_db": None}
    d_l1 = float(np.abs(np.asarray(gt_depth) - depth)[valid].mean())
    mse = float(np.square(np.asarray(gt_color) - np.clip(color, 0, 1))
                [valid].mean())
    return {"depth_l1_m": d_l1,
            "psnr_db": float(-10.0 * np.log10(max(mse, 1e-12)))}


class Visualizer:
    def __init__(self, freq: int, vis_dir: str, slam, rcfg: RenderConfig,
                 verbose: bool = True, enabled: bool = True):
        """enabled: False on the ranks that write nothing.  The reference's
        vis_inside / inside_freq (panels inside an optimisation) have no
        caller there and are left out."""
        self.freq = freq
        self.vis_dir = vis_dir
        self.slam = slam
        self.rcfg = rcfg
        self.verbose = verbose
        self.enabled = enabled
        if enabled:
            os.makedirs(vis_dir, exist_ok=True)

    def _render(self, c2w, gt_depth, npc, params, r_query_map, level: str,
                exposure_feat=None):
        s = self.slam
        lv = npc.levels[level]
        return render_img(
            params, s.mcfg, self.rcfg, c2w, s.H, s.W, s.fx, s.fy, s.cx, s.cy,
            (lv.pos, lv.count, lv.geo, lv.col), r_query_map,
            gt_depth=gt_depth, exposure_feat=exposure_feat,
            stage=f"color_{level}")

    def vis_value_only(self, c2w, gt_depth, npc, params, r_query_map,
                       level: str = "fine", exposure_feat=None):
        """Rendered (depth, uncertainty, colour) host arrays of one level."""
        return tuple(t.cpu().numpy() for t in self._render(
            c2w, gt_depth, npc, params, r_query_map, level, exposure_feat))

    def vis(self, idx: int, it: int, gt_depth, gt_color, c2w, npc, params,
            r_query: Dict[str, np.ndarray], exposure_feat=None,
            freq_override: bool = False,
            save_rendered_image: bool = False) -> List[dict]:
        """Per-level panels every ``freq`` frames.  Returns one record per
        level written: {idx, level, depth_l1_m, psnr_db, render_ms}."""
        if not self.enabled or not (freq_override or idx % self.freq == 0):
            return []
        from .image_io import write_png
        from .panels import write_panels
        dev = self.slam.device
        records = []
        for level in npc.levels.keys():
            t0 = time.perf_counter()
            out = self._render(c2w, gt_depth, npc, params, r_query[level],
                               level, exposure_feat)
            depth, _unc, color = (t.cpu().numpy() for t in out)
            render_ms = 1e3 * (time.perf_counter() - t0)
            path = os.path.join(self.vis_dir,
                                f"{idx:05d}_{it:04d}_{level}.png")
            write_panels(path, gt_depth, depth, gt_color, color)
            if save_rendered_image and level == "fine":
                img_dir = os.path.join(os.path.dirname(self.vis_dir),
                                       "rendered_image")
                os.makedirs(img_dir, exist_ok=True)
                write_png(os.path.join(img_dir, f"frame_{idx:05d}.png"),
                          (np.clip(color, 0, 1) * 255).astype(np.uint8))
            records.append({"idx": idx, "level": level,
                            "render_ms": render_ms, "device": dev.type,
                            **render_stats(gt_depth, gt_color, depth,
                                           color)})
            if self.verbose:
                print(f"Saved rendering visualization {path}", flush=True)
        return records
