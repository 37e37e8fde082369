"""Camera tracker (port of hpslam_tpu/tracker.py).

Per frame: two stages ('color_mid' then 'color_fine'), each split into
``resample_stages`` sub-stages.  A sub-stage draws a pixel set, runs one
kNN search through the tile index at the sub-stage's starting pose
(kernel 1 inside ``knn_tiles``), pre-gathers the frozen neighbour positions
and [geo | col] features, then takes pose-gradient Adam steps.  Each step
renders either through ``render_rays`` over the dense cache (the plain
path) or, with ``tracking.fused_loss``, through one fused tracker render
(``ops.fused_mlp.nicer_fused_trackloss``: kernel #8 forward, #9 backward)
over per-sub-stage cache rows.  The reference's ``lax.scan`` becomes a
Python loop; pixel draws come from a ``torch.Generator``.

Under a device mesh (``parallel.mesh``) every rank draws the sub-stage's
whole pixel set, takes the 'inside' threshold from all of it, then
searches and renders only its dp slice; the median or mean residual of the
outlier mask, the loss and the pose (and exposure) gradients are summed or
gathered over dp, so every rank takes the same Adam step.  The fused
render is single-device only, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import decoder as Dec
from .ops import fused_mlp as FM
from .ops import geometry as G
from .ops import image as IM
from .ops import knn as Knn
from .ops import optim as Opt
from .ops import sampling as Samp
from .parallel.mesh import (all_gather_rows, all_reduce_grads,
                            all_reduce_sum, shard_batch)
from .renderer import RenderConfig, render_rays


def _median(x):
    """jnp.median semantics (mean of the two middle values)."""
    return torch.quantile(x, 0.5)


def track_frame(params, mcfg: Dec.ModelConfig, rcfg: RenderConfig,
                cam_init, gen: torch.Generator,
                gt_color, gt_depth, r_query_mid, r_query_fine, pool,
                pool_len: int, level_mid, index_mid, level_fine, index_fine,
                exposure_feat, pixels: int, iters_mid: int, iters_fine: int,
                W: int, fx: float, fy: float, cx: float, cy: float,
                cam_lr: float, separate_lr: bool, use_exposure: bool,
                w_color: float, use_color: bool, handle_dynamic: bool,
                resample_stages: int = 1, knn_probe: int = 16,
                dense_cache: bool = True, fused_track: bool = False,
                mesh=None):
    """Optimise the camera of one frame.

    level_*: (pos, count, geo, col) of each level; index_*: its tile index.
    fused_track: render each step through the fused tracker render
    (baseline decoder variants only, as the reference).
    mesh: optional ``parallel.mesh.Mesh``: the pixel batch is dp-sharded
    (see the module docstring); the result is the same on every rank.
    Returns (best_cam (7,), best_loss, losses (iters,), opt_params)."""
    dev = cam_init.device
    if fused_track and mesh is not None:
        raise ValueError("fused_track: single-device path only")
    if fused_track and (mcfg.use_view_direction or mcfg.use_normals
                        or mcfg.encode_rel_pos_in_col
                        or mcfg.encode_rel_pos_in_geo):
        raise ValueError("fused_track: baseline decoder variants only")
    if mcfg.encode_rel_pos_in_geo or mcfg.encode_rel_pos_in_col \
            or fused_track:
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
        if not (dense_cache or fused_track):
            return (D, I), None
        # frozen neighbour positions and features gathered once; padded
        # slots get a 1e6 sentinel position (zero weight)
        cap = cloud_pos.shape[0]
        I2 = torch.where(D >= Knn.BIG, torch.full_like(I, cap), I)
        safe_ids = torch.clamp(I2, max=cap - 1)
        valid = (I2 < cap)[..., None]
        cpos = torch.where(valid, cloud_pos[safe_ids],
                           torch.full((), 1e6, device=dev))
        cfs = torch.where(valid, cat_feats[safe_ids],
                          torch.zeros((), dtype=cat_feats.dtype, device=dev))
        if not fused_track:
            return (D, I), (cpos, cfs)
        # the fused render's cache rows [z | d_gt | c_gt | r2 | has | nz |
        # cpos]; `has` from the frozen search distances
        n, S, kk = i.shape[0], rcfg.N_surface, rcfg.nn_num
        r2 = (rq * rq)[:, None]
        nn = torch.sum(D.reshape(n, S, kk) < r2[..., None], -1)
        has = (nn > (mcfg.min_nn_num - 1)).float()
        rowc = torch.cat([z, d_gt[:, None], c_gt, r2, has,
                          (d_gt > 0).float()[:, None],
                          cpos.reshape(n, S * kk * 3)], 1).contiguous()
        return rowc, cfs.reshape(n, S * kk * 2 * mcfg.c_dim).contiguous()

    def fused_render(pr, stage, rays_o, rays_d, d_gt, expo, rowc, cfs):
        """One fused tracker render: trunks, in-kernel differentiable
        interpolation weights, per-sample exposure and the compositor."""
        lv = stage.split("_")[1]
        gd, cd = pr[f"geo_{lv}"], pr[f"col_{lv}"]
        n = rowc.shape[0]
        use_aff = bool(mcfg.encode_exposure) and expo is not None
        if use_aff:
            rot, trans = Dec.exposure_affine(cd, expo)
            aff = torch.cat([rot.reshape(9), trans])[None].expand(n, 12)
        else:
            aff = torch.zeros((n, 12), device=dev)
        depth, unc, color = FM.nicer_fused_trackloss(
            torch.cat([rays_o, rays_d], 1), aff, rowc, cfs,
            FM.flatten_core(gd["core"]), FM.flatten_core(cd["core"]),
            (gd["B"], cd["B"]), mcfg.n_blocks, mcfg.skip, rcfg.N_surface,
            rcfg.nn_num, mcfg.c_dim, float(rcfg.sigmoid_coef),
            0 if mcfg.weighting == "distance" else 1, use_aff,
            not mcfg.encode_exposure)
        nz = d_gt > 0
        if not rcfg.sample_near_pcl:
            depth = torch.where(nz, depth, torch.zeros_like(depth))
        if rcfg.skip_zero_depth_pixel:
            color = torch.where(nz[:, None], color, torch.zeros_like(color))
        return depth, unc, color

    def loss_fn(op, stage, level, inputs, knn_cache, dense, cat_feats,
                inside_thresh):
        cam, pr, expo = assemble(op)
        c2w = G.get_camera_from_tensor(cam)
        i, j, d_gt, c_gt, rq = inputs
        rays_o, rays_d = G.get_rays_from_uv(i, j, c2w, fx, fy, cx, cy)
        pos, count, geo, col = level
        inside = d_gt <= inside_thresh
        if fused_track:
            depth, unc, color = fused_render(pr, stage, rays_o, rays_d, d_gt,
                                             expo, knn_cache, dense)
        else:
            depth, unc, color, _ = render_rays(
                pr, mcfg, rcfg, stage, rays_o, rays_d, d_gt, pos, count,
                geo, col, rq, is_tracker=True, exposure_feat=expo,
                knn_cache=knn_cache, cat_feats=cat_feats, dense_cache=dense)
        unc = unc.detach()
        ok = inside & torch.isfinite(depth) & torch.isfinite(unc)
        tmp = torch.abs(d_gt - depth) / torch.sqrt(unc + 1e-10)
        # the outlier statistics are whole-batch ones; they only select
        # rays, so no gradient flows through them
        if handle_dynamic:
            if mesh is None:
                tmp_mean = torch.sum(torch.where(ok, tmp, 0.0)) \
                    / torch.clamp(torch.sum(ok), min=1)
            else:
                tsum, cnt = all_reduce_sum(
                    mesh, torch.sum(torch.where(ok, tmp, 0.0)).detach(),
                    torch.sum(ok).float())
                tmp_mean = tsum / torch.clamp(cnt, min=1)
            mask = (tmp < 10.0 * tmp_mean) & (d_gt > 0)
        else:
            ad = torch.abs(d_gt - depth)
            med = torch.nanquantile(all_gather_rows(
                mesh, torch.where(ok, ad, float("nan")).detach(), pixels),
                0.5)
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
        # the [geo | col] gather table, bfloat16 under mm_bf16: the tracker
        # never writes features, and the gathers upcast after the mix
        cat_feats = torch.cat([geo, col], dim=1)
        if mcfg.mm_bf16:
            cat_feats = cat_feats.to(torch.bfloat16)
        for s in range(resample_stages):
            sub = iters // resample_stages + (
                1 if s < iters % resample_stages else 0)
            if sub == 0:
                continue
            inputs = stage_inputs(r_query_map)
            # the threshold from the whole pixel set, then this rank's slice
            d_gt_stage = inputs[2]
            inside_thresh = torch.minimum(10.0 * _median(d_gt_stage),
                                          1.2 * torch.max(d_gt_stage))
            inputs = shard_batch(mesh, *inputs)
            knn_cache, dense = stage_knn(inputs, tile_index, pos, cat_feats,
                                         current_cam(state["op"]).detach())
            for _ in range(sub):
                op = Opt.tree_map(lambda t: t.detach().requires_grad_(),
                                  state["op"])
                leaves = Opt.tree_leaves(op)
                loss = loss_fn(op, stage, level, inputs, knn_cache, dense,
                               cat_feats, inside_thresh)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                if mesh is not None:
                    grads, loss = all_reduce_grads(mesh, grads, leaves,
                                                   loss.detach())
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


class Tracker:
    """Host-side per-frame driver: dynamic radii, pixel pools, pose init and
    the track_frame call."""

    def __init__(self, cfg: dict, slam):
        self.cfg = cfg
        self.slam = slam
        t = cfg["tracking"]
        self.iters = t["iters"]
        self.pixels = t["pixels"]
        self.cam_lr = t["lr"]
        self.separate_lr = t["separate_LR"]
        self.w_color = t["w_color_loss"]
        self.use_color = t["use_color_in_tracking"]
        self.handle_dynamic = t["handle_dynamic"]
        self.sample_with_color_grad = t["sample_with_color_grad"]
        self.ignore_edge_W = t["ignore_edge_W"]
        self.ignore_edge_H = t["ignore_edge_H"]
        self.const_speed = t["const_speed_assumption"]
        self.resample_stages = int(t.get("resample_stages", 1))
        self.knn_probe = int(t.get("knn_probe", 12))
        self.dense_cache = bool(t.get("dense_cache", True))
        # the fused tracker render; 'auto' means off, as in the reference
        # off the TPU
        fused = t.get("fused_loss", False)
        self.fused_loss = fused != "auto" and bool(fused)
        self.gt_camera = t["gt_camera"]
        self.depth_limit = 5.0 if t["depth_limit"] else None
        self.ratio_iter_mid = 0.5
        self.use_exposure = cfg["model"]["encode_exposure"]
        self.radius_hierarchy = cfg["pointcloud"]["radius_hierarchy"]
        self.radius_query_ratio = cfg["pointcloud"]["radius_query_ratio"]
        self.color_grad_threshold = cfg["pointcloud"]["color_grad_threshold"]
        self.rcfg = RenderConfig.from_cfg(cfg, "sigmoid_coef_tracker")
        self.gen = torch.Generator(device=slam.device)
        self.gen.manual_seed(int(cfg.get("seed", 1219)) + 2)

    def fused_ok(self) -> bool:
        """The fused render covers the baseline decoder on one device; a
        mesh or a variant knob (rel-pos, normals, view direction) takes the
        plain path, as the reference's _fused_ok does."""
        m = self.slam.mcfg
        return self.fused_loss and getattr(self.slam, "mesh", None) is None \
            and not (m.use_view_direction or m.use_normals
            or m.encode_rel_pos_in_col or m.encode_rel_pos_in_geo)

    def prepare_radii(self, color: np.ndarray):
        return IM.dynamic_radii(color, self.radius_hierarchy,
                                self.radius_query_ratio,
                                self.color_grad_threshold)

    def build_pool(self, color: np.ndarray, depth: np.ndarray) -> np.ndarray:
        H, W = depth.shape
        He, We = self.ignore_edge_H, self.ignore_edge_W
        if self.sample_with_color_grad:
            return IM.top_grad_index_pool(
                color, self.pixels, He, H - He, We, W - We, gt_depth=depth,
                depth_limit=self.depth_limit is not None)
        return IM.valid_pixel_pool(depth, He, H - He, We, W - We,
                                   self.depth_limit)

    def initial_pose(self, idx: int, estimate_c2w_list) -> np.ndarray:
        """Constant-speed motion model."""
        pre = estimate_c2w_list[idx - 1]
        if self.const_speed and idx >= 2:
            delta = pre @ np.linalg.inv(estimate_c2w_list[idx - 2])
            return delta @ pre
        return pre.copy()

    def track(self, idx: int, frame, npc, params, exposure_feat,
              estimate_c2w_list, gt_c2w: np.ndarray):
        """Track one frame: (c2w 4x4, info, updated opt params or None)."""
        slam = self.slam
        dev = slam.device
        H, W = frame.depth.shape
        _r_add, r_query = self.prepare_radii(frame.color)
        if idx <= 1 or self.gt_camera:
            return gt_c2w.copy(), {"skipped": True, "r_query": r_query}, None
        est_init = self.initial_pose(idx, estimate_c2w_list)
        cam_init = G.get_tensor_from_camera_np(est_init)
        gt_cam = G.get_tensor_from_camera_np(gt_c2w)
        if float(np.dot(cam_init[:4], gt_cam[:4])) < 0:
            cam_init[:4] *= -1
        pool = self.build_pool(frame.color, frame.depth)
        lv_mid, lv_fine = npc.levels["mid"], npc.levels["fine"]
        iters_mid = int(self.iters * self.ratio_iter_mid)
        # the fused trunk kernels are off for tracking (as the reference)
        mcfg_run = dataclasses.replace(slam.mcfg, fused_mlp=False)
        best_cam, best_loss, losses, op = track_frame(
            params, mcfg_run, self.rcfg,
            torch.as_tensor(cam_init, dtype=torch.float32, device=dev),
            self.gen, frame.color_t(dev), frame.depth_t(dev),
            torch.as_tensor(r_query["mid"], device=dev),
            torch.as_tensor(r_query["fine"], device=dev),
            torch.as_tensor(pool.astype(np.int64), device=dev),
            max(pool.shape[0], 1),
            (lv_mid.pos, lv_mid.count, lv_mid.geo, lv_mid.col),
            npc.index("mid"),
            (lv_fine.pos, lv_fine.count, lv_fine.geo, lv_fine.col),
            npc.index("fine"),
            torch.as_tensor(np.asarray(exposure_feat), device=dev),
            pixels=self.pixels, iters_mid=iters_mid,
            iters_fine=self.iters - iters_mid, W=W, fx=slam.fx, fy=slam.fy,
            cx=slam.cx, cy=slam.cy, cam_lr=self.cam_lr,
            separate_lr=self.separate_lr, use_exposure=self.use_exposure,
            w_color=self.w_color, use_color=self.use_color,
            handle_dynamic=self.handle_dynamic,
            resample_stages=self.resample_stages, knn_probe=self.knn_probe,
            dense_cache=self.dense_cache, fused_track=self.fused_ok(),
            mesh=getattr(slam, "mesh", None))
        best_cam = best_cam.detach().cpu().numpy()
        best_loss = float(best_loss)
        losses = losses.cpu().numpy()
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :] = G.get_camera_from_tensor_np(best_cam)
        info = {
            "loss_init": float(losses[0]) if losses.size else 0.0,
            "loss_best": best_loss,
            "loss_curve": np.asarray(losses, np.float64).round(3).tolist(),
            "cam_error_quad": float(np.abs(gt_cam[:4] - best_cam[:4]).mean()),
            "cam_error_pos": float(np.abs(gt_cam[4:] - best_cam[4:]).mean()),
            "r_query": r_query,
        }
        return c2w, info, op
