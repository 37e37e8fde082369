"""Frozen copy of hpslam_tpu_torch/tracker.py's plain single-device route
for the benchmark's reference (imports nothing of the program).

Per frame: two stages ('color_mid' then 'color_fine'), each split into
``resample_stages`` sub-stages.  A sub-stage draws a pixel set from the
tracker's generator, runs one kNN search through the tile index at the
sub-stage's starting pose, pre-gathers the frozen neighbour positions and
[geo | col] features where the decoder has no rel-pos encoding, then takes
pose-gradient Adam steps, each rendering through ``render_rays``.  The
host helpers (dynamic radii, pixel pool, constant-speed initial pose)
follow ``Tracker``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import decoder as Dec
from . import geometry as G
from . import image as IM
from . import knn as Knn
from . import optim as Opt
from . import sampling as Samp
from .render import RenderConfig, render_rays


def track_frame(params, mcfg: Dec.ModelConfig, rcfg: RenderConfig,
                cam_init, gen: torch.Generator, gt_color, gt_depth,
                r_query_mid, r_query_fine, pool, pool_len: int, level_mid,
                index_mid, level_fine, index_fine, exposure_feat,
                pixels: int, iters_mid: int, iters_fine: int, W: int,
                fx: float, fy: float, cx: float, cy: float, cam_lr: float,
                separate_lr: bool, use_exposure: bool, w_color: float,
                use_color: bool, handle_dynamic: bool,
                resample_stages: int = 1, knn_probe: int = 16,
                dense_cache: bool = True):
    """Optimise the camera of one frame.  Returns (best_cam (7,),
    best_loss, losses (iters,), opt_params)."""
    dev = cam_init.device
    if mcfg.encode_rel_pos_in_geo or mcfg.encode_rel_pos_in_col:
        dense_cache = False
    if separate_lr:
        opt_params = {"quad": cam_init[:4].clone(), "T": cam_init[4:].clone()}
        lr_tree = {"quad": cam_lr * 0.2, "T": cam_lr}
    else:
        opt_params = {"cam": cam_init.clone()}
        lr_tree = {"cam": cam_lr}
    if use_exposure:
        opt_params["expo_feat"] = exposure_feat.clone()
        opt_params["expo_mid"] = Opt.tree_map(torch.clone,
                                              params["col_mid"]["exposure"])
        opt_params["expo_fine"] = Opt.tree_map(
            torch.clone, params["col_fine"]["exposure"])
        lr_tree["expo_feat"] = 0.001
        lr_tree["expo_mid"] = 0.001
        lr_tree["expo_fine"] = 0.001

    def current_cam(op):
        return torch.cat([op["quad"], op["T"]]) if separate_lr else op["cam"]

    def assemble(op):
        pr = params
        if use_exposure:
            pr = dict(params)
            pr["col_mid"] = dict(params["col_mid"], exposure=op["expo_mid"])
            pr["col_fine"] = dict(params["col_fine"],
                                  exposure=op["expo_fine"])
        return current_cam(op), pr, (op["expo_feat"] if use_exposure
                                     else None)

    def stage_inputs(r_query_map):
        ids = Samp.sample_indices(gen, pool[:pool_len], pixels)
        i = (ids % W).float()
        j = torch.div(ids, W, rounding_mode="floor")
        jj, ii = j, ids % W
        return (i, j.float(), gt_depth[jj, ii], gt_color[jj, ii],
                r_query_map[jj, ii])

    @torch.no_grad()
    def stage_knn(inputs, tile_index, cloud_pos, cat_feats, cam):
        i, j, d_gt, c_gt, rq = inputs
        c2w = G.get_camera_from_tensor(cam)
        rays_o, rays_d = G.get_rays_from_uv(i, j, c2w, fx, fy, cx, cy)
        safe = torch.where(d_gt > 0, d_gt, torch.ones_like(d_gt))
        z = Samp.surface_z_vals(safe, rcfg.N_surface, rcfg.near_end_surface,
                                rcfg.far_end_surface, rcfg.fix_interval)
        p = (rays_o[:, None] + rays_d[:, None] * z[..., None]).reshape(-1, 3)
        D, I = Knn.knn_tiles(p, *tile_index, k=rcfg.nn_num, probe=knn_probe)
        if not dense_cache:
            return (D, I), None
        cap = cloud_pos.shape[0]
        I2 = torch.where(D >= Knn.BIG, torch.full_like(I, cap), I)
        safe_ids = torch.clamp(I2, max=cap - 1)
        valid = (I2 < cap)[..., None]
        cpos = torch.where(valid, cloud_pos[safe_ids],
                           torch.full((), 1e6, device=dev))
        cfs = torch.where(valid, cat_feats[safe_ids],
                          torch.zeros((), dtype=cat_feats.dtype, device=dev))
        return (D, I), (cpos, cfs)

    def loss_fn(op, stage, level, inputs, knn_cache, dense, cat_feats,
                inside_thresh):
        cam, pr, expo = assemble(op)
        c2w = G.get_camera_from_tensor(cam)
        i, j, d_gt, c_gt, rq = inputs
        rays_o, rays_d = G.get_rays_from_uv(i, j, c2w, fx, fy, cx, cy)
        pos, count, geo, col = level
        inside = d_gt <= inside_thresh
        depth, unc, color, _ = render_rays(
            pr, mcfg, rcfg, stage, rays_o, rays_d, d_gt, pos, count, geo,
            col, rq, is_tracker=True, exposure_feat=expo,
            knn_cache=knn_cache, cat_feats=cat_feats, dense_cache=dense)
        unc = unc.detach()
        ok = inside & torch.isfinite(depth) & torch.isfinite(unc)
        tmp = torch.abs(d_gt - depth) / torch.sqrt(unc + 1e-10)
        if handle_dynamic:
            tmp_mean = torch.sum(torch.where(ok, tmp, 0.0)) \
                / torch.clamp(torch.sum(ok), min=1)
            mask = (tmp < 10.0 * tmp_mean) & (d_gt > 0)
        else:
            ad = torch.abs(d_gt - depth)
            med = torch.nanquantile(
                torch.where(ok, ad, float("nan")).detach(), 0.5)
            med = torch.nan_to_num(med, nan=1e9)
            mask = (ad < 10.0 * med) & (d_gt > 0)
        mask = mask & ok
        loss = torch.sum(torch.where(mask, torch.clamp(tmp, 0.0, 1e3), 0.0))
        if use_color:
            loss = loss + w_color * torch.sum(
                torch.where(mask[:, None], torch.abs(c_gt - color), 0.0))
        return loss

    state = {"op": opt_params, "ost": Opt.init(opt_params),
             "best_loss": torch.tensor(1e20, device=dev),
             "best_cam": cam_init.clone()}
    losses = []

    def run_stage(stage, level, tile_index, r_query_map, iters):
        pos, _count, geo, col = level
        cat_feats = torch.cat([geo, col], dim=1)
        for s in range(resample_stages):
            sub = iters // resample_stages + (
                1 if s < iters % resample_stages else 0)
            if sub == 0:
                continue
            inputs = stage_inputs(r_query_map)
            d_gt_stage = inputs[2]
            inside_thresh = torch.minimum(
                10.0 * torch.quantile(d_gt_stage, 0.5),
                1.2 * torch.max(d_gt_stage))
            knn_cache, dense = stage_knn(inputs, tile_index, pos, cat_feats,
                                         current_cam(state["op"]).detach())
            for _ in range(sub):
                op = Opt.tree_map(lambda t: t.detach().requires_grad_(),
                                  state["op"])
                leaves = Opt.tree_leaves(op)
                loss = loss_fn(op, stage, level, inputs, knn_cache, dense,
                               cat_feats, inside_thresh)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                gtree = Opt.tree_unflatten(op, grads)
                new_op, state["ost"] = Opt.update(
                    gtree, state["ost"], Opt.tree_map(torch.detach, op),
                    lr_tree)
                state["op"] = new_op
                cam = current_cam(new_op)
                loss = loss.detach()
                better = loss < state["best_loss"]
                state["best_loss"] = torch.where(better, loss,
                                                 state["best_loss"])
                state["best_cam"] = torch.where(better, cam,
                                                state["best_cam"])
                losses.append(loss)

    run_stage("color_mid", level_mid, index_mid, r_query_mid, iters_mid)
    run_stage("color_fine", level_fine, index_fine, r_query_fine, iters_fine)
    loss_t = (torch.stack(losses) if losses
              else torch.zeros((0,), device=dev))
    return state["best_cam"], state["best_loss"], loss_t, state["op"]


def initial_pose(idx: int, est_prev: np.ndarray, est_prev2: np.ndarray,
                 const_speed: bool) -> np.ndarray:
    """Constant-speed motion model from the two previous estimates."""
    if const_speed and idx >= 2:
        return (est_prev @ np.linalg.inv(est_prev2)) @ est_prev
    return est_prev.copy()


def build_pool(cfg: dict, color: np.ndarray, depth: np.ndarray):
    t = cfg["tracking"]
    H, W = depth.shape
    He, We = t["ignore_edge_H"], t["ignore_edge_W"]
    if t["sample_with_color_grad"]:
        return IM.top_grad_index_pool(
            color, t["pixels"], He, H - He, We, W - We, gt_depth=depth,
            depth_limit=bool(t["depth_limit"]))
    return IM.valid_pixel_pool(depth, He, H - He, We, W - We,
                               5.0 if t["depth_limit"] else None)


def track(cfg: dict, cam: dict, frame_color, frame_depth, idx: int,
          est_prev, est_prev2, gt_c2w, levels: dict, indices: dict,
          params, exposure_feat, gen: torch.Generator, device):
    """The tracker's call for frame ``idx`` on the given map.  levels:
    {level: (pos, count, geo, col)} at full capacity; indices: {level:
    tile index}.  Returns (best_cam (7,) numpy, losses (iters,) numpy)."""
    t = cfg["tracking"]
    pc = cfg["pointcloud"]
    mcfg = Dec.ModelConfig.from_cfg(cfg)
    rcfg = RenderConfig.from_cfg(cfg, "sigmoid_coef_tracker")
    H, W = frame_depth.shape
    _r_add, r_query = IM.dynamic_radii(frame_color, pc["radius_hierarchy"],
                                       pc["radius_query_ratio"],
                                       pc["color_grad_threshold"])
    est_init = initial_pose(idx, est_prev, est_prev2,
                            t["const_speed_assumption"])
    cam_init = G.get_tensor_from_camera_np(est_init)
    gt_cam = G.get_tensor_from_camera_np(gt_c2w)
    if float(np.dot(cam_init[:4], gt_cam[:4])) < 0:
        cam_init[:4] *= -1
    pool = build_pool(cfg, frame_color, frame_depth)
    iters = int(t["iters"])
    iters_mid = int(iters * 0.5)
    best_cam, _best, losses, _op = track_frame(
        params, mcfg, rcfg,
        torch.as_tensor(cam_init, dtype=torch.float32, device=device), gen,
        torch.as_tensor(frame_color, device=device),
        torch.as_tensor(frame_depth, device=device),
        torch.as_tensor(r_query["mid"], device=device),
        torch.as_tensor(r_query["fine"], device=device),
        torch.as_tensor(pool.astype(np.int64), device=device),
        max(pool.shape[0], 1), levels["mid"], indices["mid"],
        levels["fine"], indices["fine"],
        torch.as_tensor(np.asarray(exposure_feat), device=device),
        pixels=int(t["pixels"]), iters_mid=iters_mid,
        iters_fine=iters - iters_mid, W=W, fx=cam["fx"], fy=cam["fy"],
        cx=cam["cx"], cy=cam["cy"], cam_lr=float(t["lr"]),
        separate_lr=bool(t["separate_LR"]),
        use_exposure=bool(cfg["model"]["encode_exposure"]),
        w_color=float(t["w_color_loss"]),
        use_color=bool(t["use_color_in_tracking"]),
        handle_dynamic=bool(t["handle_dynamic"]),
        resample_stages=int(t.get("resample_stages", 1)),
        knn_probe=int(t.get("knn_probe", 12)),
        dense_cache=bool(t.get("dense_cache", True)))
    return best_cam.detach().cpu().numpy(), losses.cpu().numpy()
