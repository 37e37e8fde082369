"""Mapper (port of hpslam_tpu/mapper.py), union path.

Per mapped frame: point insertion, then for each level (mid, fine) one
union neighbour cache over the keyframe window (``build_pixel_union_cache``:
one kNN search, interpolation weights, per-ray top-u union), a compaction
of the scene to the rows the cache can touch, and ``map_scan``: the
level's geometry-then-colour iterations.  With ``model.fused_composite``
(the default) each iteration is one call of the mapping-loss kernel
(``ops.fused_mlp.nicer_fused_maploss``, kernel #3 under autograd) plus the
feature-row gather, its deterministic scatter-add backward and Adam;
without it, the union render (``render_union``: union-slot feature mix,
the fused trunks of kernels #4-5 or the plain trunks, the compositor) and
the masked L1 losses run as tensor ops around the trunk kernels.

Under a device mesh (``parallel.mesh``, dp ranks) the union cache's query
search is dp-sharded and the cache is then gathered whole on every rank;
each ``map_scan`` iteration renders this rank's dp slice of the rays
through ``render_union`` (the mapping-loss kernel is single-device, as in
the reference), where ``model.fused_composite`` takes the fused composite
(kernel #6 forward, kernel #5 in its backward), and the gradients and the
two loss terms are summed over dp before Adam.

Not ported (raise NotImplementedError): bundle adjustment (mapping.BA with
more than four keyframes) and the per-sample (non-union) mapping path that
rel-pos encodings need.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .models import decoder as Dec
from .ops import composite as Co
from .ops import fused_mlp as FM
from .ops import geometry as G
from .ops import image as IM
from .ops import interpolate as IT
from .ops import knn as Knn
from .ops import optim as Opt
from .ops import sampling as Samp
from .parallel.mesh import all_gather_rows, all_reduce_grads, shard_batch
from .renderer import RenderConfig


@torch.no_grad()
def reprojection_visible(pts, prev_w2c, fx, fy, cx, cy, H: int, W: int):
    uv, _z = G.project_points(pts, prev_w2c, fx, fy, cx, cy)
    return (uv[:, 0] < W) & (uv[:, 0] > 0) & (uv[:, 1] < H) & (uv[:, 1] > 0)


def keyframe_selection_overlap(rng: np.random.Generator, depth, c2w,
                               keyframe_poses, k: int, fx, fy, cx, cy,
                               n_samples: int = 8, pixels: int = 200):
    """Rank keyframes by frustum overlap with the current view (host
    numpy, as the reference)."""
    H, W = depth.shape
    valid = np.flatnonzero(depth.ravel() > 0)
    if valid.size == 0 or len(keyframe_poses) == 0:
        return []
    sel = valid[rng.integers(0, valid.size, size=min(pixels, valid.size))]
    jj, ii = np.unravel_index(sel, (H, W))
    d = depth[jj, ii]
    dirs = np.stack([(ii - cx) / fx, -(jj - cy) / fy,
                     -np.ones_like(ii, np.float64)], -1)
    rd = dirs @ c2w[:3, :3].T
    ro = c2w[:3, 3]
    t = np.linspace(0.0, 1.0, n_samples)
    near = (d * 0.8)[:, None]
    far = (d + 0.5)[:, None]
    z = near * (1 - t) + far * t
    pts = (ro[None, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
    scores = []
    for kid, kf_c2w in enumerate(keyframe_poses):
        w2c = np.linalg.inv(kf_c2w)
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        zc = cam[:, 2:3] + 1e-5
        u = (fx * cam[:, 0] + cx * zc[:, 0]) / zc[:, 0]
        v = (fy * cam[:, 1] + cy * zc[:, 0]) / zc[:, 0]
        edge = 20
        m = ((u < W - edge) & (u > edge) & (v < H - edge) & (v > edge)
             & (cam[:, 2] < 0))
        scores.append((kid, float(m.mean())))
    overlapping = [kid for kid, s in sorted(scores, key=lambda x: -x[1])
                   if s > 0.0]
    return list(rng.permutation(np.array(overlapping, np.int64))[:k])


@torch.no_grad()
def build_pixel_union_cache(gen: torch.Generator, depths, c2ws, pools,
                            pool_lens, rq_stack, tile_index, capacity: int,
                            P: int, S: int, k: int, u_max: int, H: int,
                            W: int, fx, fy, cx, cy, near_surface: float,
                            far_surface: float, min_nn: int, weighting: str,
                            colors=None, fix_interval: bool = False,
                            knn_probe: int = 16, mesh=None):
    """Union-dedup pixel cache over the F window frames.

    Per cached pixel: uids (u_max,) — the union of its S*k neighbour ids,
    top-u_max by total interpolation weight (ties to the first occurrence
    in sample-major order, padding = capacity); Wm (S, u_max) per-sample
    L1-renormalised weights over the union; pmask (S,) sample-has-
    neighbours.  Plus the flat per-pixel phase constants.  The union
    ranking runs through kernel 1 (top-u of -score).  Under a mesh each
    rank searches and unionizes its dp slice of the pixels, then the
    per-pixel rows are gathered whole on every rank.
    Returns (cache_pix (F, P), uids (F, P, u), Wm (F, P, S, u),
    pmask (F, P, S), const dict)."""
    F = depths.shape[0]
    dev = depths.device
    r = torch.randint(0, 2 ** 31 - 1, (F, P), generator=gen,
                      device=dev) % pool_lens[:, None]
    idx = torch.gather(pools, 1, r)                               # (F, P)
    jj = torch.div(idx, W, rounding_mode="floor")
    ii = idx % W
    fidx = torch.arange(F, device=dev)[:, None]
    d = depths[fidx, jj, ii]
    rq = rq_stack[fidx, jj, ii]
    c_gt = (colors[fidx, jj, ii] if colors is not None
            else torch.zeros((F, P, 3), device=dev))
    dirs = G.camera_dirs(ii.float(), jj.float(), fx, fy, cx, cy)   # (F,P,3)
    rays_d = torch.einsum("fpd,fkd->fpk", dirs, c2ws[:, :3, :3])
    rays_o = c2ws[:, :3, 3]
    safe = torch.where(d > 0, d, torch.ones_like(d))
    z = Samp.surface_z_vals(safe, S, near_surface, far_surface,
                            fix_interval)                        # (F,P,S)
    pts = rays_o[:, None, None, :] + rays_d[:, :, None, :] * z[..., None]
    FP = F * P
    const = {"z": z.reshape(FP, S), "pts": pts.reshape(FP, S, 3),
             "rays_d": rays_d.reshape(FP, 3), "d_gt": d.reshape(FP),
             "c_gt": c_gt.reshape(FP, 3)}
    # dp-sharded by whole pixels (a no-op without a mesh)
    pq, rq_l = shard_batch(mesh, pts.reshape(FP, S, 3), rq.reshape(FP))
    qf = pq.reshape(-1, 3)
    D, I = Knn.knn_tiles(qf, *tile_index, k=k, probe=knn_probe)
    rq_rep = torch.repeat_interleave(rq_l, S)
    w, has = IT.interp_weights(D, I, qf, None, rq_rep, min_nn, weighting,
                               diff_pos=False)
    w = w[..., 0]                                                 # (FPS, k)
    SK = S * k
    ids = I.reshape(-1, SK)
    wf = w.reshape(-1, SK)
    iota = torch.arange(SK, device=dev)
    eq = ids[:, :, None] == ids[:, None, :]                       # (R,SK,SK)
    tw = torch.sum(torch.where(eq, torch.abs(wf)[:, None, :], 0.0), dim=2)
    first = torch.min(torch.where(eq, iota[None, None, :], SK), dim=2).values
    score = torch.where(first == iota[None, :], tw, torch.full_like(tw, -1.0))
    # top-u by score, ties to the lower position: kernel 1 on -score
    neg, sel_f = Knn.topk_rows(-score, None, u_max)
    twk = -neg
    sel = torch.round(sel_f).to(torch.int64)
    uids_raw = torch.gather(ids, 1, sel)
    uids = torch.where(twk > 0, uids_raw, torch.full_like(uids_raw, capacity))
    match = (ids[:, None, :] == uids_raw[:, :, None]) & (twk > 0)[..., None]
    Wm = (match.to(wf.dtype) * wf[:, None, :]).reshape(-1, u_max, S, k)
    Wm = torch.sum(Wm, dim=3).permute(0, 2, 1)                   # (R, S, u)
    rs = torch.sum(torch.abs(Wm), dim=2, keepdim=True)
    Wm = torch.where(rs > 1e-12, Wm / torch.clamp(rs, min=1e-12), 0.0)
    if mesh is not None:
        # every rank's rows, whole, in one gather: [Wm | has | uids] as f32
        # (ids as exact f32 values, as pack_union_cache stores them)
        R = uids.shape[0]
        rows = all_gather_rows(mesh, torch.cat([
            Wm.reshape(R, S * u_max), has.reshape(R, S).float(),
            Knn.pack_ids(uids)], 1), FP)
        Wm = rows[:, :S * u_max]
        has = rows[:, S * u_max:S * u_max + S] > 0.5
        uids = Knn.unpack_ids(rows[:, S * u_max + S:])
    return (idx, uids.reshape(F, P, u_max), Wm.reshape(F, P, S, u_max),
            has.reshape(F, P, S), const)


def pack_union_cache(const, Wm, pmask, uids):
    """One flat f32 row per cached pixel: [z S | pts 3S | rays_d 3 | d_gt 1 |
    c_gt 3 | pmask S | Wm S*u | uids u (pack_ids values)]."""
    FP, S = const["z"].shape
    u = uids.shape[-1]
    return torch.cat([const["z"], const["pts"].reshape(FP, S * 3),
                      const["rays_d"], const["d_gt"][:, None],
                      const["c_gt"], pmask.reshape(FP, S).float(),
                      Wm.reshape(FP, S * u),
                      Knn.pack_ids(uids.reshape(FP, u))], dim=1).contiguous()


def count_unique(cacheI) -> int:
    return int(torch.unique(cacheI.reshape(-1)).numel())


@torch.no_grad()
def compact_scene(cacheI, pos, geo, col, U: int):
    """Compact the scene to the rows ``cacheI`` can reach: (uniq (U,) ids,
    padding = capacity; remapped cache; pos/geo/col (U, ...))."""
    cap = pos.shape[0]
    flat = cacheI.reshape(-1)
    u = torch.unique(flat)
    if u.numel() > U:
        raise ValueError("compact_scene: more unique rows than U")
    uniq = torch.cat([u, torch.full((U - u.numel(),), cap, dtype=u.dtype,
                                    device=u.device)])
    remap = torch.searchsorted(uniq, flat).reshape(cacheI.shape)
    safe = torch.clamp(uniq, max=cap - 1)
    return uniq, remap, pos[safe], geo[safe], col[safe]


def unique_bucket(n: int, cap: int) -> int:
    for u in (8192, 32768, 131072, 262144):
        if n <= u:
            return min(u, cap)
    u = 524288
    while u < n:
        u <<= 1
    return min(u, cap)


def map_scan(params, mcfg: Dec.ModelConfig, rcfg: RenderConfig, opt_params,
             opt_state, gen: torch.Generator, depths, cache_pix,
             cache_packed, u_sz: int, expo_stack, lr_table, F_actual: int,
             level: str, n_rays: int, geo_iters: int, use_exposure: bool,
             opt_color_dec: bool, w_color: float, mesh=None):
    """One level phase of the mapping schedule on the union path.

    opt_params: {'feat' (U, 2C) packed [geo | col] table, optional 'dec'
    (the level's colour decoder tree), optional 'expo_feat'}.
    lr_table: (n_iters, 4) per-iteration LRs [decoders, geo, col, BA].
    mesh: optional ``parallel.mesh.Mesh``: each iteration's rays are
    dp-sharded, gradients and losses summed over dp (module docstring).
    Returns (opt_params, opt_state, losses (n_iters, 2) [geo, color])."""
    dev = cache_packed.device
    use_fused_loss = (mcfg.fused_composite and Dec.fused_usable(mcfg)
                      and mesh is None)
    n_iters = lr_table.shape[0]
    F_max = depths.shape[0]
    P = cache_pix.shape[1]
    S = rcfg.N_surface
    C = mcfg.c_dim
    o = FM.row_offsets(S, u_sz)
    # 'inside' threshold once per phase from the cached pixel pool
    pj = torch.div(cache_pix, depths.shape[2], rounding_mode="floor")
    pi = cache_pix % depths.shape[2]
    d_pool = depths[torch.arange(F_max, device=dev)[:, None], pj, pi]
    validf = torch.arange(F_max, device=dev)[:, None] < F_actual
    sd = torch.sort(torch.where(validf, d_pool, float("inf")).reshape(-1))[0]
    n_val = F_actual * P
    inside_thresh = torch.minimum(10.0 * sd[max((n_val - 1) // 2, 0)],
                                  1.2 * sd[max(n_val - 1, 0)])
    fid = torch.arange(n_rays, device=dev) % F_actual
    geo_flat = [w.contiguous() for w in FM.flatten_core(
        params[f"geo_{level}"]["core"])]
    Bs = (params[f"geo_{level}"]["B"].contiguous(),
          params[f"col_{level}"]["B"].contiguous())

    def lr_tree_for(lrs):
        tree = {"feat": torch.cat([torch.full((C,), float(lrs[1]),
                                              device=dev),
                                   torch.full((C,), float(lrs[2]),
                                              device=dev)])}
        if "dec" in opt_params:
            tree["dec"] = float(lrs[0])
        if "expo_feat" in opt_params:
            tree["expo_feat"] = 0.001
        return tree

    def col_dec_of(op):
        return op["dec"] if "dec" in op else params[f"col_{level}"]

    def exposure_sel(op, dec, fid):
        ef = expo_stack.clone()
        if "expo_feat" in op:
            ef = torch.cat([ef[:F_actual - 1], op["expo_feat"][None],
                            ef[F_actual:]])
        rots, transs = Dec.exposure_affine(dec, ef)
        oh = (fid[:, None] == torch.arange(F_max, device=dev)[None, :]
              ).float()
        return oh @ torch.cat([rots.reshape(F_max, 9), transs], dim=1)

    def render_union(col_dec, with_color, row, feat, uids):
        """Union-cache render without the loss kernel: the union-slot
        feature mix of the packed row, then the fused composite (trunks
        and compositor, kernel #6) where fused_composite and
        fused_usable, else the trunks (fused where fused_usable; sample
        positions are phase constants, so no dp), -100 forcing and the
        compositor.  Exposure applies outside.  Returns (depth, color,
        valid ray)."""
        n = row.shape[0]
        z = row[:, o["z"]:o["z"] + S]
        pts = row[:, o["pts"]:o["pts"] + 3 * S].reshape(n * S, 3)
        rays_d = row[:, o["rays_d"]:o["rays_d"] + 3]
        pmf = (row[:, o["pm"]:o["pm"] + S] > 0.5).reshape(-1)
        Wm = row[:, o["wm"]:o["wm"] + S * u_sz].reshape(n, S, u_sz)
        c_all = IT.union_gather(feat, uids, Wm).reshape(n * S, -1)
        c_all = torch.where(pmf[:, None], c_all, 0.0)
        c_geo = c_all[:, :C]
        geo_dec = params[f"geo_{level}"]
        fused = Dec.fused_usable(mcfg)
        vmask = Dec.valid_ray_mask(pmf, S, rcfg.N_surface)
        if mcfg.fused_composite and fused:
            depth, _unc, color = FM.nicer_fused_composite(
                c_geo, c_all[:, C:] if with_color else None, pts, z,
                row[:, o["pm"]:o["pm"] + S], FM.flatten_core(geo_dec["core"]),
                FM.flatten_core(col_dec["core"]), (geo_dec["B"], col_dec["B"]),
                mcfg.n_blocks, mcfg.skip, with_color, S,
                float(rcfg.sigmoid_coef), True, not mcfg.encode_exposure)
            return depth, color, vmask
        if with_color:
            if fused:
                occ, rgb = Dec.fused_color_pair(
                    geo_dec, col_dec, mcfg, pts, c_geo, c_all[:, C:],
                    need_dp=False, need_wgrads=opt_color_dec)
            else:
                occ = Dec.apply_geo(geo_dec, mcfg, pts, c_geo)
                views_d = (torch.repeat_interleave(rays_d, S, dim=0)
                           if mcfg.use_view_direction else None)
                rgb = Dec.apply_color(col_dec, mcfg, pts, c_all[:, C:],
                                      views_d=views_d)
        else:
            occ = (Dec.fused_geo(geo_dec, mcfg, pts, c_geo, need_dp=False)
                   if fused else Dec.apply_geo(geo_dec, mcfg, pts, c_geo))
            rgb = torch.zeros((n * S, 3), device=dev)
        occ = torch.where(pmf, occ, -100.0)
        raw = torch.cat([rgb, occ[:, None]], -1).reshape(n, S, 4)
        depth, _unc, color, _ = Co.raw2outputs(
            raw, z, rays_d, occupancy=rcfg.occupancy, coef=rcfg.sigmoid_coef)
        return depth, color, vmask

    def plain_stage_loss(op, dec, fid, row, feat, uids, d_gt, inside,
                         with_color):
        """The stage loss around render_union: masked L1 depth loss and,
        on colour stages, the per-frame exposure affine + sigmoid of the
        composited colour and the masked L1 colour loss."""
        depth, color, vmask = render_union(dec, with_color, row, feat, uids)
        mask = (d_gt > 0) & vmask & torch.isfinite(depth) & inside
        gl = torch.sum(torch.where(mask, torch.abs(d_gt - depth), 0.0))
        if not with_color:
            return gl, gl, torch.zeros((), device=dev)
        if use_exposure:
            sel = exposure_sel(op, dec, fid)
            color = torch.sigmoid(torch.einsum(
                "nc,ncd->nd", color, sel[:, :9].reshape(-1, 3, 3))
                + sel[:, 9:])
        c_gt = row[:, o["c_gt"]:o["c_gt"] + 3]
        cl = torch.sum(torch.where(mask[:, None], torch.abs(c_gt - color),
                                   0.0))
        return gl + w_color * cl, gl, cl

    def stage_loss(op, fid, slot, with_color):
        row = cache_packed[fid * P + slot]
        d_gt = row[:, o["d_gt"]]
        uids = Knn.unpack_ids(row[:, o["uids"]:o["uids"] + u_sz])
        inside = d_gt <= inside_thresh
        n = row.shape[0]
        # geometry stages read only the geo half of the feature rows: the
        # colour columns have zero cotangent there
        feat_v = op["feat"] if with_color else op["feat"][:, :C]
        dec = col_dec_of(op)
        if not use_fused_loss:
            return plain_stage_loss(op, dec, fid, row, feat_v, uids, d_gt,
                                    inside, with_color)
        uf = IT.gather_rows(feat_v, uids).reshape(n, -1)
        okf = ((d_gt > 0) & inside).float()[:, None]
        use_aff = bool(use_exposure) and with_color
        aff = (exposure_sel(op, dec, fid) if use_aff
               else torch.zeros((n, 12), device=dev))
        col_flat = [w if w.is_contiguous() else w.contiguous()
                    for w in FM.flatten_core(dec["core"])]
        gl, cl = FM.nicer_fused_maploss(
            uf, aff.contiguous(), col_flat, row, okf, geo_flat, Bs,
            mcfg.n_blocks, mcfg.skip, with_color, S, u_sz, C,
            float(rcfg.sigmoid_coef), not mcfg.encode_exposure, use_aff,
            float(w_color), need_wgrads=opt_color_dec)
        if with_color:
            return gl + w_color * cl, gl, cl
        return gl, gl, torch.zeros((), device=dev)

    losses = []
    op, ost = opt_params, opt_state
    for it in range(n_iters):
        with_color = it >= geo_iters
        slot = torch.randint(0, P, (n_rays,), generator=gen, device=dev)
        opg = Opt.tree_map(lambda t: t.detach().requires_grad_(), op)
        leaves = Opt.tree_leaves(opg)
        total, gl, cl = stage_loss(opg, *shard_batch(mesh, fid, slot),
                                   with_color)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        if mesh is not None:
            grads, gl, cl = all_reduce_grads(mesh, grads, leaves,
                                             gl.detach(), cl.detach())
        gtree = Opt.tree_unflatten(opg, grads)
        op, ost = Opt.update(gtree, ost, Opt.tree_map(torch.detach, opg),
                             lr_tree_for(lr_table[it]))
        losses.append(torch.stack([gl.detach(), cl.detach()]))
    loss_t = (torch.stack(losses) if losses
              else torch.zeros((0, 2), device=dev))
    return op, ost, loss_t


def build_schedule(n_joint: int, mid_ratio: float, geo_ratio: float,
                   init: bool, geo_iter_first: int, lr_cfg: dict,
                   ba_cam_lr: float = 0.0, color_refine: bool = False):
    """Per-phase (mid, fine) stage ids + 4-group LR tables (identical to the
    reference's build_schedule)."""
    num_mid = int(n_joint * mid_ratio)
    num_fine = int(n_joint * (1 - mid_ratio))
    A = geo_iter_first if init else int(num_mid * geo_ratio)
    B = num_mid
    Cb = int(num_mid + num_fine * geo_ratio)
    block = lr_cfg["init"] if init else lr_cfg["stage"]
    out = {}
    for level, rng_ in (("mid", range(0, min(B, n_joint - 1) + 1)),
                        ("fine", range(min(B, n_joint - 1) + 1, n_joint))):
        names = {0: f"geometry_{level}", 1: f"color_{level}"}
        ids, lrs = [], []
        for j in rng_:
            if level == "mid":
                s = 0 if j <= A else 1
                ba_on = (num_mid * (geo_ratio + 0.2) <= j
                         <= num_mid * (geo_ratio + 0.3))
            else:
                s = 0 if j <= Cb else 1
                ba_on = (num_mid + num_fine * (geo_ratio + 0.2) <= j
                         <= num_mid + num_fine * (geo_ratio + 0.3))
            g = block[names[s]]
            ids.append(s)
            if color_refine:
                cf = block[f"color_{level}"]
                lrs.append([0.0, 0.0, cf["color_lr"] / 10.0, 0.0])
            else:
                lrs.append([g["decoders_lr"], g[f"geometry_{level}_lr"],
                            g["color_lr"], ba_cam_lr if ba_on else 0.0])
        out[level] = (np.asarray(ids, np.int32),
                      np.asarray(lrs, np.float32).reshape(-1, 4))
    return out


def bucket_iters(n: int, base: int) -> int:
    buckets = sorted({max(1, int(base * f))
                      for f in (0.95, 1.0, 1.25, 1.5, 2.0)})
    return min(buckets, key=lambda b: abs(b - n))


class Mapper:
    """Host-side driver: point adding, keyframe window, schedule and the
    per-level cache build + map_scan."""

    def __init__(self, cfg: dict, slam):
        self.cfg = cfg
        self.slam = slam
        m = cfg["mapping"]
        self.every_frame = m["every_frame"]
        self.iters = m["iters"]
        self.iters_first = m["iters_first"]
        self.geo_iter_first = m["geo_iter_first"]
        self.geo_iter_ratio = m["geo_iter_ratio"]
        self.mid_iter_ratio = m["mid_iter_ratio"]
        self.mapping_pixels = m["pixels"]
        self.pixels_adding = m["pixels_adding"]
        self.pixels_color_grad = m.get("pixels_based_on_color_grad", 0)
        self.window_size = m["mapping_window_size"]
        self.keyframe_every = m["keyframe_every"]
        self.w_color = m["w_color_loss"]
        self.more_iters_when_adding = m["more_iters_when_adding"]
        self.min_iter_ratio = m["min_iter_ratio"]
        self.filter_before_add = m["filter_before_add_points"]
        self.kf_selection_method = m["keyframe_selection_method"]
        self.fix_color_decoder = m["fix_color_decoder"]
        self.fix_geo_mid = m["fix_geo_decoder_mid"]
        self.fix_geo_fine = m["fix_geo_decoder_fine"]
        self.lr_cfg = {"init": m["init"], "stage": m["stage"]}
        self.use_exposure = cfg["model"]["encode_exposure"]
        self.radius_hierarchy = cfg["pointcloud"]["radius_hierarchy"]
        self.radius_query_ratio = cfg["pointcloud"]["radius_query_ratio"]
        self.color_grad_threshold = cfg["pointcloud"]["color_grad_threshold"]
        self.rcfg = RenderConfig.from_cfg(cfg, "sigmoid_coef_mapper")
        self.rng = np.random.default_rng(cfg.get("seed", 1219))
        self.gen = torch.Generator(device=slam.device)
        self.gen.manual_seed(int(cfg.get("seed", 1219)) + 3)
        self.prev_c2w: Optional[np.ndarray] = None
        self.keyframe_list: List[int] = []
        self.keyframe_dict: List[dict] = []
        self.selected_keyframes: Dict[int, list] = {}

    def _sample_valid(self, depth: np.ndarray, n: int):
        pool = IM.valid_pixel_pool(depth, 0, depth.shape[0], 0,
                                   depth.shape[1])
        sel = pool[self.rng.integers(0, pool.shape[0], size=n)]
        jj, ii = np.unravel_index(sel, depth.shape)
        return ii, jj

    def _rays(self, ii, jj, c2w):
        slam = self.slam
        dirs = np.stack([(ii - slam.cx) / slam.fx, -(jj - slam.cy) / slam.fy,
                         -np.ones_like(ii, np.float64)], -1).astype(
            np.float32)
        rays_d = (dirs @ c2w[:3, :3].T).astype(np.float32)
        rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).astype(np.float32)
        return rays_o, rays_d

    def _visible(self, rays_o, rays_d, depth_s, H, W):
        slam = self.slam
        dev = slam.device
        prev_w2c = torch.as_tensor(np.linalg.inv(self.prev_c2w),
                                   dtype=torch.float32, device=dev)
        pts = torch.as_tensor(rays_o + rays_d * depth_s[:, None],
                              device=dev)
        return reprojection_visible(pts, prev_w2c, slam.fx, slam.fy,
                                    slam.cx, slam.cy, H, W).cpu().numpy()

    def add_points_for_frame(self, idx, frame, c2w, npc, r_add) -> int:
        """Non-overlap + overlap insertion batches (plus optional colour-
        gradient-targeted additions)."""
        H, W = frame.depth.shape
        if idx == 0:
            med = float(np.median(frame.depth[frame.depth > 0])) if \
                (frame.depth > 0).any() else 2.5
            n_add = int(np.clip(self.pixels_adding * (med / 2.5) ** 2,
                                self.pixels_adding, self.pixels_adding * 3))
        else:
            n_add = self.pixels_adding
        ii, jj = self._sample_valid(frame.depth, n_add)
        rays_o, rays_d = self._rays(ii, jj, c2w)
        depth_s = frame.depth[jj, ii]
        color_s = frame.color[jj, ii]
        total_fine = 0
        if self.filter_before_add and idx != 0:
            mask_add = ~self._visible(rays_o, rays_d, depth_s, H, W)
            for level in ("fine", "mid"):
                n = npc.add_neural_points(
                    rays_o, rays_d, depth_s, color_s, level,
                    dynamic_radius=r_add[level][jj, ii], valid=mask_add,
                    record_input=(level == "fine"))
                total_fine += n if level == "fine" else 0
            ii2, jj2 = self._sample_valid(frame.depth, 1000)
            rays_o2, rays_d2 = self._rays(ii2, jj2, c2w)
            depth2 = frame.depth[jj2, ii2]
            color2 = frame.color[jj2, ii2]
            visible2 = self._visible(rays_o2, rays_d2, depth2, H, W)
            for level in ("fine", "mid"):
                n = npc.add_neural_points(
                    rays_o2, rays_d2, depth2, color2, level,
                    dynamic_radius=r_add[level][jj2, ii2], valid=visible2,
                    record_input=(level == "fine"))
                total_fine += n if level == "fine" else 0
        else:
            for level in ("fine", "mid"):
                n = npc.add_neural_points(
                    rays_o, rays_d, depth_s, color_s, level,
                    dynamic_radius=r_add[level][jj, ii],
                    record_input=(level == "fine"))
                total_fine += n if level == "fine" else 0
        if self.pixels_color_grad > 0:
            pool = IM.top_grad_index_pool(
                frame.color, self.pixels_color_grad, 0, H, 0, W, ratio=5,
                gt_depth=frame.depth)
            if pool.size > 0:
                sel = self.rng.choice(
                    pool, size=min(self.pixels_color_grad, pool.size),
                    replace=False)
                jj2, ii2 = np.unravel_index(sel, (H, W))
                rays_o2, rays_d2 = self._rays(ii2, jj2, c2w)
                for level in ("fine", "mid"):
                    n = npc.add_neural_points(
                        rays_o2, rays_d2, frame.depth[jj2, ii2],
                        frame.color[jj2, ii2], level,
                        dynamic_radius=r_add[level][jj2, ii2],
                        is_pts_grad=True, record_input=(level == "fine"))
                    total_fine += n if level == "fine" else 0
        return int(total_fine)

    def select_window(self, idx, frame, c2w, method: Optional[str] = None):
        slam = self.slam
        method = method or self.kf_selection_method
        win = getattr(self, "_effective_window", self.window_size)
        if len(self.keyframe_dict) == 0:
            frames = []
        elif method == "global":
            num = win - 2
            frames = list(range(max(0, len(self.keyframe_dict) - 1 - num),
                                len(self.keyframe_dict) - 1))
        else:
            frames = keyframe_selection_overlap(
                self.rng, frame.depth, c2w,
                [kf["est_c2w"] for kf in self.keyframe_dict[:-1]],
                win - 2, slam.fx, slam.fy, slam.cx, slam.cy)
        if len(self.keyframe_list) > 0:
            frames = frames + [len(self.keyframe_list) - 1]
        return frames + [-1]

    def map(self, idx: int, frame, npc, params, exposure_feat, c2w,
            color_refine: bool = False):
        """Map one frame: (params, exposure_feat, info)."""
        slam = self.slam
        dev = slam.device
        H, W = frame.depth.shape
        init = idx == 0
        base_window = self.window_size * (2 if slam.n_img > 4000 else 1)
        self._effective_window = base_window * (2 if color_refine else 1)
        kf_method = "global" if color_refine else self.kf_selection_method
        r_add, r_query = IM.dynamic_radii(
            frame.color, self.radius_hierarchy, self.radius_query_ratio,
            self.color_grad_threshold)
        window = self.select_window(idx, frame, c2w, kf_method)
        if self.cfg["mapping"].get("save_selected_keyframes_info", True):
            self.selected_keyframes[idx] = [
                {"idx": int(self.keyframe_list[f] if f != -1 else idx)}
                for f in window]
        frame_pts_add = 0 if color_refine else self.add_points_for_frame(
            idx, frame, c2w, npc, r_add)
        if (not color_refine and len(self.keyframe_list) > 4
                and self.cfg["mapping"]["BA"]):
            raise NotImplementedError("mapping.BA (bundle adjustment) is not "
                                      "ported yet; see ROADMAP.md")
        if slam.mcfg.encode_rel_pos_in_col or slam.mcfg.encode_rel_pos_in_geo:
            raise NotImplementedError("the per-sample mapping path that "
                                      "rel-pos encodings need is not ported "
                                      "yet; see ROADMAP.md")
        n_joint = self.iters_first if init else self.iters
        if color_refine:
            n_joint = self.iters * 2
        elif self.more_iters_when_adding and idx > 0:
            n = int(np.clip(n_joint * frame_pts_add / 300,
                            int(self.min_iter_ratio * n_joint), 2 * n_joint))
            n_joint = (n if self.cfg["mapping"].get("exact_iter_counts")
                       else bucket_iters(n, self.iters))
        schedules = build_schedule(
            n_joint, self.mid_iter_ratio,
            0.0 if color_refine else self.geo_iter_ratio, init,
            self.geo_iter_first, self.lr_cfg, color_refine=color_refine)

        F_actual = len(window)
        F_max = max(self._effective_window + 2, F_actual)
        cols_l, deps_l, rqm_l, rqf_l, pools_l = [], [], [], [], []
        c2ws = np.tile(np.eye(4, dtype=np.float32), (F_max, 1, 1))
        pool_lens = np.ones((F_max,), np.int64)
        expo = np.zeros((F_max, self.cfg["model"]["exposure_dim"]),
                        np.float32)
        for slot, f in enumerate(window):
            if f == -1:
                pool = IM.valid_pixel_pool(frame.depth, 0, H, 0, W)
                pj = np.zeros((H * W,), np.int64)
                pj[:pool.size] = pool
                cols_l.append(frame.color_t(dev))
                deps_l.append(frame.depth_t(dev))
                rqm_l.append(torch.as_tensor(r_query["mid"], device=dev))
                rqf_l.append(torch.as_tensor(r_query["fine"], device=dev))
                pools_l.append(torch.as_tensor(pj, device=dev))
                pool_lens[slot] = max(pool.size, 1)
                c2ws[slot] = c2w
                expo[slot] = np.asarray(exposure_feat)
            else:
                kf = self.keyframe_dict[f]
                cols_l.append(kf["color_t"])
                deps_l.append(kf["depth_t"])
                rqm_l.append(kf["rqm_t"])
                rqf_l.append(kf["rqf_t"])
                pools_l.append(kf["pool_t"])
                pool_lens[slot] = kf["pool_len"]
                c2ws[slot] = kf["est_c2w"]
                expo[slot] = kf.get("exposure_feat",
                                    np.zeros_like(np.asarray(exposure_feat)))
        pad_n = F_max - F_actual
        z3 = torch.zeros((H, W, 3), device=dev)
        z2 = torch.zeros((H, W), device=dev)
        zp = torch.zeros((H * W,), dtype=torch.int64, device=dev)
        colors = torch.stack(cols_l + [z3] * pad_n)
        depths = torch.stack(deps_l + [z2] * pad_n)
        rqm = torch.stack(rqm_l + [z2] * pad_n)
        rqf = torch.stack(rqf_l + [z2] * pad_n)
        pools = torch.stack(pools_l + [zp] * pad_n)
        pool_lens_t = torch.as_tensor(pool_lens, device=dev)
        c2ws_t = torch.as_tensor(c2ws, device=dev)
        expo_t = torch.as_tensor(expo, device=dev)

        opt_color_dec = not self.fix_color_decoder
        if not (self.fix_geo_mid and self.fix_geo_fine):
            raise NotImplementedError(
                "optimising the geometry decoders needs the per-sample "
                "mapping path, which is not ported yet; see ROADMAP.md")
        n_rays = self.mapping_pixels
        new_params = dict(params)
        new_expo = exposure_feat
        losses_all = []
        shared_t = None
        P = int(self.cfg["mapping"].get(
            "pixels_knn_cache", max(2000, 4 * (n_rays // max(1, F_actual)))))
        u_max = int(self.cfg["mapping"].get("union_size", 8))
        knn_probe = int(self.cfg["mapping"].get("knn_probe", 12))
        for level in ("mid", "fine"):
            stage_ids, lr_table = schedules[level]
            if stage_ids.size == 0:
                continue
            lv = npc.levels[level]
            cache_pix, cacheI, cacheWm, cachePm, const = \
                build_pixel_union_cache(
                    self.gen, depths, c2ws_t, pools, pool_lens_t,
                    rqm if level == "mid" else rqf, npc.index(level),
                    lv.capacity, P=P, S=self.rcfg.N_surface,
                    k=self.rcfg.nn_num, u_max=u_max, H=H, W=W, fx=slam.fx,
                    fy=slam.fy, cx=slam.cx, cy=slam.cy,
                    near_surface=self.rcfg.near_end_surface,
                    far_surface=self.rcfg.far_end_surface,
                    min_nn=slam.mcfg.min_nn_num,
                    weighting=slam.mcfg.weighting, colors=colors,
                    fix_interval=self.rcfg.fix_interval,
                    knn_probe=knn_probe, mesh=slam.mesh)
            n_geo = int(np.sum(stage_ids == 0))
            if not ((stage_ids[:n_geo] == 0).all()
                    and (stage_ids[n_geo:] == 1).all()):
                raise ValueError("map_scan needs a contiguous geometry "
                                 "prefix")
            U = unique_bucket(count_unique(cacheI), lv.capacity)
            uniq, cacheI_c, _pos_c, geo_c, col_c = compact_scene(
                cacheI, lv.pos, lv.geo, lv.col, U)
            packed = pack_union_cache(const, cacheWm, cachePm, cacheI_c)
            opt_params = {"feat": torch.cat([geo_c, col_c], 1)}
            if opt_color_dec:
                opt_params["dec"] = Opt.tree_map(
                    torch.clone, new_params[f"col_{level}"])
            if self.use_exposure:
                opt_params["expo_feat"] = torch.as_tensor(
                    np.asarray(new_expo), dtype=torch.float32, device=dev)
            ostate = Opt.init(opt_params)
            if shared_t is not None:
                ostate["t"] = shared_t["t"]
                if "expo_feat" in ostate["m"] and "m_expo" in shared_t:
                    ostate["m"]["expo_feat"] = shared_t["m_expo"]
                    ostate["v"]["expo_feat"] = shared_t["v_expo"]
            opt_params, ostate, losses = map_scan(
                new_params, slam.mcfg, self.rcfg, opt_params, ostate,
                self.gen, depths, cache_pix, packed, u_max, expo_t,
                lr_table, F_actual, level, n_rays, n_geo, self.use_exposure,
                opt_color_dec, self.w_color, mesh=slam.mesh)
            C = slam.mcfg.c_dim
            npc.scatter_feats(uniq, opt_params["feat"][:, :C],
                              opt_params["feat"][:, C:], level)
            if opt_color_dec:
                new_params[f"col_{level}"] = opt_params["dec"]
            if self.use_exposure:
                new_expo = opt_params["expo_feat"].cpu().numpy()
            shared_t = {"t": ostate["t"]}
            if "expo_feat" in ostate["m"]:
                shared_t["m_expo"] = ostate["m"]["expo_feat"]
                shared_t["v_expo"] = ostate["v"]["expo_feat"]
            losses_all.append(losses.cpu().numpy())

        self.prev_c2w = c2w
        loss_np = (np.concatenate(losses_all, axis=0) if losses_all
                   else np.zeros((1, 2)))
        step = max(1, loss_np.shape[0] // 120)
        info = {
            "frame_pts_add": frame_pts_add,
            "n_joint_iters": int(n_joint),
            "geo_loss_last": float(loss_np[-1, 0]),
            "color_loss_last": float(loss_np[-1, 1]),
            "geo_loss_curve": loss_np[::step, 0].round(3).tolist(),
            "color_loss_curve": loss_np[::step, 1].round(3).tolist(),
            "window": window,
            "r_query": r_query,
            "updated_c2w": None,
        }
        return new_params, new_expo, info

    def maybe_register_keyframe(self, idx, frame, c2w, gt_c2w, r_query,
                                exposure_feat, n_img):
        is_kf = (idx % self.keyframe_every == 0 or idx == n_img - 2)
        if not is_kf or idx in self.keyframe_list:
            return False
        if not np.isfinite(gt_c2w).all():
            return False
        dev = self.slam.device
        self.keyframe_list.append(idx)
        H, W = frame.depth.shape
        pool = IM.valid_pixel_pool(frame.depth, 0, H, 0, W)
        pj = np.zeros((H * W,), np.int64)
        pj[:pool.size] = pool
        # keys ending in "_t" are device tensors; the Logger strips them
        self.keyframe_dict.append({
            "idx": idx,
            "color": frame.color.copy(),
            "depth": frame.depth.copy(),
            "gt_c2w": gt_c2w.copy(),
            "est_c2w": c2w.copy(),
            "r_query_mid": r_query["mid"].copy(),
            "r_query_fine": r_query["fine"].copy(),
            "exposure_feat": np.asarray(exposure_feat).copy(),
            "color_t": frame.color_t(dev),
            "depth_t": frame.depth_t(dev),
            "rqm_t": torch.as_tensor(r_query["mid"], device=dev),
            "rqf_t": torch.as_tensor(r_query["fine"], device=dev),
            "pool_t": torch.as_tensor(pj, device=dev),
            "pool_len": int(max(pool.size, 1)),
        })
        return True
