"""Differentiable depth-guided volume renderer (port of
hpslam_tpu/renderer.py).

Every ray gets ``N_surface`` depth-guided samples in
[near_end_surface*d, far_end_surface*d]; zero-depth rays use caller-supplied
z values (``sample_near_pcl_z``) or a linspace up to a far bound.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .models import decoder as Dec
from .ops import composite as C
from .ops import knn as K
from .ops import sampling as S


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    N_surface: int = 5
    near_end: float = 0.3
    near_end_surface: float = 0.98
    far_end_surface: float = 1.02
    sigmoid_coef: float = 0.1
    sample_near_pcl: bool = True
    skip_zero_depth_pixel: bool = False
    fix_interval: bool = False
    nn_num: int = 8
    occupancy: bool = True

    @classmethod
    def from_cfg(cls, cfg: dict, sigmoid_coef_key: str = "sigmoid_coef_mapper"):
        r = cfg["rendering"]
        return cls(
            N_surface=r["N_surface"], near_end=r["near_end"],
            near_end_surface=r["near_end_surface"],
            far_end_surface=r["far_end_surface"],
            sigmoid_coef=r[sigmoid_coef_key],
            sample_near_pcl=r["sample_near_pcl"],
            skip_zero_depth_pixel=r["skip_zero_depth_pixel"],
            fix_interval=cfg["pointcloud"]["fix_interval_when_add_along_ray"],
            nn_num=cfg["pointcloud"]["nn_num"])


def render_rays(params, mcfg: Dec.ModelConfig, rcfg: RenderConfig,
                stage: str, rays_o, rays_d, gt_depth, cloud_pos, cloud_count,
                geo_feats, col_feats, r_query, is_tracker: bool = False,
                exposure_feat=None, far_fallback=None,
                zero_depth_z_vals: Optional[torch.Tensor] = None,
                knn_cache=None, tile_index=None, cat_feats=None,
                dense_cache=None):
    """Render one batch of rays at one stage/level.  Returns depth (N,),
    uncertainty (N,), color (N, 3), valid_ray_mask (N,).

    knn_cache: precomputed (D, I) for the N*N_surface samples (the
    optimisation loops freeze neighbour sets); dense_cache: pre-gathered
    (cpos (Q, k, 3), cfeat (Q, k, 2C)) frozen neighbours (tracker)."""
    N = rays_o.shape[0]
    S_pts = rcfg.N_surface
    nz = gt_depth > 0
    safe_depth = torch.where(nz, gt_depth, torch.ones_like(gt_depth))
    z_surface = S.surface_z_vals(safe_depth, S_pts, rcfg.near_end_surface,
                                 rcfg.far_end_surface, rcfg.fix_interval)
    if zero_depth_z_vals is None:
        if far_fallback is None:
            far_fallback = S.far_bound_from_depth(
                torch.where(nz, gt_depth, torch.zeros_like(gt_depth)))
        t = torch.linspace(0.0, 1.0, S_pts, device=rays_o.device)
        zero_depth_z_vals = (rcfg.near_end * (1 - t) + far_fallback * t
                             ).expand(N, S_pts)
    z_vals = torch.where(nz[:, None], z_surface, zero_depth_z_vals)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    p = pts.reshape(-1, 3)
    rq = torch.repeat_interleave(r_query, S_pts, dim=0)
    if knn_cache is not None:
        D, I = knn_cache
    elif tile_index is not None:
        D, I = K.knn_tiles(p.detach(), *tile_index, k=rcfg.nn_num)
    else:
        D, I = K.knn_auto(p.detach(), cloud_pos, cloud_count, k=rcfg.nn_num)
    views_d = None
    if mcfg.use_view_direction:
        views_d = torch.repeat_interleave(rays_d, S_pts, dim=0)
    raw, vmask, point_mask = Dec.eval_stage(
        params, mcfg, stage, p, D, I, geo_feats, col_feats, cloud_pos, rq,
        n_pts_per_ray=S_pts, is_tracker=is_tracker, views_d=views_d,
        exposure_feat=exposure_feat, cat_feats=cat_feats,
        dense_cache=dense_cache)
    occ = torch.where(point_mask, raw[:, -1], -100.0)
    raw = torch.cat([raw[:, :3], occ[:, None]], dim=-1).reshape(N, S_pts, 4)
    depth, uncertainty, color, _ = C.raw2outputs(
        raw, z_vals, rays_d, occupancy=rcfg.occupancy,
        coef=rcfg.sigmoid_coef)
    if not rcfg.sample_near_pcl:
        depth = torch.where(nz, depth, torch.zeros_like(depth))
    if rcfg.skip_zero_depth_pixel:
        color = torch.where(nz[:, None], color, torch.zeros_like(color))
    return depth, uncertainty, color, vmask


@torch.no_grad()
def sample_near_pcl_z(rays_o, rays_d, near, far, n_surface: int, cloud_pos,
                      cloud_count, r_query, nn_num: int = 8,
                      intervals: int = 25, tile_index=None):
    """z values near the point cloud for zero-depth rays: returns
    (z_vals (N, n_surface), invalid (N,))."""
    N = rays_o.shape[0]
    dev = rays_o.device
    z_probe = torch.linspace(float(near), float(far), intervals, device=dev)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_probe[None, :, None]
    if tile_index is not None:
        D, _ = K.knn_tiles(pts.reshape(-1, 3), *tile_index, k=nn_num)
    else:
        D, _ = K.knn_auto(pts.reshape(-1, 3), cloud_pos, cloud_count,
                          k=nn_num)
    nn = K.neighbor_counts(D, torch.repeat_interleave(r_query, intervals))
    has = (nn > 0).reshape(N, intervals)
    invalid = torch.sum(has.to(torch.int64), 1) < 2
    first = torch.argmax(has.to(torch.int64), 1)
    last = intervals - 1 - torch.argmax(has.flip(1).to(torch.int64), 1)
    t = torch.linspace(0.0, 1.0, n_surface, device=dev)
    z_hit = z_probe[first][:, None] * (1 - t) + z_probe[last][:, None] * t
    z_full = torch.linspace(float(near), float(far), n_surface,
                            device=dev).expand(N, n_surface)
    return torch.where(invalid[:, None], z_full, z_hit), invalid
