"""Frozen copy of hpslam_tpu_torch/mapper.py's and state.py's plain
single-device route for the benchmark's reference (imports nothing of the
program).

``map_call`` runs one mapped frame's call as the mapper runs it, from
the point store, decoders, keyframe registry and random-stream states the
call started from: the keyframe window (overlap ranking on the mapper's
numpy generator), point insertion (the store's generator; 1-NN through the
tile index against the per-pixel add radius), the iteration count from
the points added, then per level (mid, fine) the neighbour cache (the
union cache on the union path, the per-sample cache otherwise), its
compaction, the level's iterations (on the union path the mapping loss
``maploss_plain``, what kernel #3 computes, over the row gather of the
compacted features; on the per-sample path ``render_rays`` over the cached
neighbours; each with its Adam step) and the features' write-back; or
only the first ``n_follow`` iterations of the mid level.
"""
from __future__ import annotations

import numpy as np
import torch

from . import decoder as Dec
from . import geometry as G
from . import image as IM
from . import interpolate as IT
from . import knn as Knn
from . import optim as Opt
from . import sampling as Samp
from .render import RenderConfig, render_rays

TILE_COUNT_CAP = 4096


# ---------------------------------------------------------------------------
# point store (state.py)

def ray_points(rays_o, rays_d, z):
    """rays_o + rays_d * z rounded as one fused multiply-add (emulated in
    float64, then rounded to float32)."""
    return (rays_o.double() + rays_d.double() * z.double()).float()


class Store:
    """One level per name: pos / geo / col at a power-of-two capacity and
    the active count, the tile index rebuilt after every change."""

    def __init__(self, cfg: dict, levels: dict, gen: torch.Generator):
        pc = cfg["pointcloud"]
        self.N_add = int(pc["N_add"])
        self.near, self.far = pc["near_end_surface"], pc["far_end_surface"]
        self.levels = levels        # {name: [pos, geo, col, count]}
        self.gen = gen
        self._index = {}

    def ensure_capacity(self, level, incoming):
        pos, geo, col, count = self.levels[level]
        cap = pos.shape[0]
        need = count + incoming
        if need > cap:
            new_cap = max(cap * 2, 1 << (need - 1).bit_length())
            pad = new_cap - cap
            z = lambda a: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
            self.levels[level] = [z(pos), z(geo), z(col), count]
            self._index.pop(level, None)

    def index(self, level):
        if level not in self._index:
            pos, _g, _c, count = self.levels[level]
            tile = max(128, pos.shape[0] // TILE_COUNT_CAP)
            self._index[level] = Knn.build_tiles(pos, count, tile=tile)
        return self._index[level]

    @torch.no_grad()
    def add(self, rays_o, rays_d, gt_depth, level, dynamic_radius,
            valid=None):
        """add_neural_points + add_points: returns the locations added."""
        dev = self.levels[level][0].device
        rays_o = torch.as_tensor(np.asarray(rays_o, np.float32), device=dev)
        rays_d = torch.as_tensor(np.asarray(rays_d, np.float32), device=dev)
        gt_depth = torch.as_tensor(np.asarray(gt_depth, np.float32),
                                   device=dev)
        B = rays_o.shape[0]
        if B == 0:
            return 0
        valid = (gt_depth > 0 if valid is None
                 else torch.as_tensor(np.asarray(valid), device=dev)
                 & (gt_depth > 0))
        r_add = torch.as_tensor(np.asarray(dynamic_radius, np.float32),
                                device=dev)
        self.ensure_capacity(level, B * self.N_add)
        pos, geo, col, count = self.levels[level]
        pts_gt = ray_points(rays_o, rays_d, gt_depth[:, None])
        D1, _ = Knn.knn_tiles(pts_gt, *self.index(level), k=1, probe=32)
        keep = valid & (D1[:, 0] >= torch.square(r_add))
        n_add = self.N_add
        t = torch.linspace(0.0, 1.0, n_add, device=dev)
        z_vals = self.near * gt_depth[:, None] * (1 - t) \
            + self.far * gt_depth[:, None] * t
        pts = ray_points(rays_o[:, None, :], rays_d[:, None, :],
                         z_vals[..., None])
        C = geo.shape[1]
        geo_new = 0.1 * torch.randn((B, n_add, C), generator=self.gen,
                                    device=dev)
        col_new = 0.1 * torch.randn((B, n_add, C), generator=self.gen,
                                    device=dev)
        n_locs = int(keep.sum())
        self._index.pop(level, None)
        if n_locs == 0:
            return 0
        dest = (count + torch.arange(n_locs, device=dev)[:, None]
                + n_locs * torch.arange(n_add, device=dev)[None, :])
        dest = dest.reshape(-1)
        pos[dest] = pts[keep].reshape(-1, 3)
        geo[dest] = geo_new[keep].reshape(-1, C)
        col[dest] = col_new[keep].reshape(-1, C)
        self.levels[level][3] = count + n_locs * n_add
        return n_locs


# ---------------------------------------------------------------------------
# the mapper's host logic (mapper.py)

def keyframe_selection_overlap(rng, depth, c2w, keyframe_poses, k, fx, fy,
                               cx, cy, n_samples=8, pixels=200):
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


def bucket_iters(n: int, base: int) -> int:
    buckets = sorted({max(1, int(base * f))
                      for f in (0.95, 1.0, 1.25, 1.5, 2.0)})
    return min(buckets, key=lambda b: abs(b - n))


def build_schedule(n_joint, mid_ratio, geo_ratio, init, geo_iter_first,
                   lr_cfg):
    """Per level (mid, fine): stage ids (0 geometry, 1 colour) and LR rows
    [decoders, geometry, colour, BA camera] (mapper.build_schedule, no BA,
    no colour refinement)."""
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
            s = (0 if j <= A else 1) if level == "mid" else \
                (0 if j <= Cb else 1)
            g = block[names[s]]
            ids.append(s)
            lrs.append([g["decoders_lr"], g[f"geometry_{level}_lr"],
                        g["color_lr"], 0.0])
        out[level] = (np.asarray(ids, np.int32),
                      np.asarray(lrs, np.float32).reshape(-1, 4))
    return out


def valid_pixel_pool_padded(depth, H, W):
    pool = IM.valid_pixel_pool(depth, 0, H, 0, W)
    pj = np.zeros((H * W,), np.int64)
    pj[:pool.size] = pool
    return pj, max(pool.size, 1)


@torch.no_grad()
def draw_cache_pixels(gen, pools, pool_lens, P):
    r = torch.randint(0, 2 ** 31 - 1, (pools.shape[0], P), generator=gen,
                      device=pools.device) % pool_lens[:, None]
    return torch.gather(pools, 1, r)


@torch.no_grad()
def pixel_samples(idx, depths, c2ws, S, W, fx, fy, cx, cy, near_surface,
                  far_surface, fix_interval=False):
    F = idx.shape[0]
    jj = torch.div(idx, W, rounding_mode="floor")
    ii = idx % W
    d = depths[torch.arange(F, device=idx.device)[:, None], jj, ii]
    dirs = G.camera_dirs(ii.float(), jj.float(), fx, fy, cx, cy)
    rays_d = torch.einsum("fpd,fkd->fpk", dirs, c2ws[:, :3, :3])
    rays_o = c2ws[:, :3, 3]
    safe = torch.where(d > 0, d, torch.ones_like(d))
    z = Samp.surface_z_vals(safe, S, near_surface, far_surface, fix_interval)
    pts = rays_o[:, None, None, :] + rays_d[:, :, None, :] * z[..., None]
    return jj, ii, d, rays_d, z, pts


@torch.no_grad()
def union_cache(gen, depths, c2ws, pools, pool_lens, rq_stack, tile_index,
                capacity, P, S, k, u_max, W, fx, fy, cx, cy, near_surface,
                far_surface, min_nn, weighting, colors, fix_interval,
                knn_probe):
    """mapper.build_pixel_union_cache on one device."""
    F = depths.shape[0]
    dev = depths.device
    idx = draw_cache_pixels(gen, pools, pool_lens, P)
    jj, ii, d, rays_d, z, pts = pixel_samples(
        idx, depths, c2ws, S, W, fx, fy, cx, cy, near_surface, far_surface,
        fix_interval)
    fidx = torch.arange(F, device=dev)[:, None]
    rq = rq_stack[fidx, jj, ii]
    c_gt = colors[fidx, jj, ii]
    FP = F * P
    const = {"z": z.reshape(FP, S), "pts": pts.reshape(FP, S, 3),
             "rays_d": rays_d.reshape(FP, 3), "d_gt": d.reshape(FP),
             "c_gt": c_gt.reshape(FP, 3)}
    qf = pts.reshape(-1, 3)
    D, I = Knn.knn_tiles(qf, *tile_index, k=k, probe=knn_probe)
    rq_rep = torch.repeat_interleave(rq.reshape(FP), S)
    w, has = IT.interp_weights(D, I, qf, None, rq_rep, min_nn, weighting,
                               diff_pos=False)
    w = w[..., 0]
    SK = S * k
    ids = I.reshape(-1, SK)
    wf = w.reshape(-1, SK)
    iota = torch.arange(SK, device=dev)
    eq = ids[:, :, None] == ids[:, None, :]
    tw = torch.sum(torch.where(eq, torch.abs(wf)[:, None, :], 0.0), dim=2)
    first = torch.min(torch.where(eq, iota[None, None, :], SK), dim=2).values
    score = torch.where(first == iota[None, :], tw, torch.full_like(tw, -1.0))
    neg, sel_f = Knn.topk_rows(-score, None, u_max)
    twk = -neg
    sel = torch.round(sel_f).to(torch.int64)
    uids_raw = torch.gather(ids, 1, sel)
    uids = torch.where(twk > 0, uids_raw, torch.full_like(uids_raw, capacity))
    match = (ids[:, None, :] == uids_raw[:, :, None]) & (twk > 0)[..., None]
    Wm = (match.to(wf.dtype) * wf[:, None, :]).reshape(-1, u_max, S, k)
    Wm = torch.sum(Wm, dim=3).permute(0, 2, 1)
    rs = torch.sum(torch.abs(Wm), dim=2, keepdim=True)
    Wm = torch.where(rs > 1e-12, Wm / torch.clamp(rs, min=1e-12), 0.0)
    return (idx, uids.reshape(F, P, u_max), Wm.reshape(F, P, S, u_max),
            has.reshape(F, P, S), const)


@torch.no_grad()
def knn_cache(gen, depths, c2ws, pools, pool_lens, tile_index, P, S, k, W,
              fx, fy, cx, cy, near_surface, far_surface):
    """mapper.build_pixel_knn_cache on one device."""
    idx = draw_cache_pixels(gen, pools, pool_lens, P)
    F, P = idx.shape
    pts = pixel_samples(idx, depths, c2ws, S, W, fx, fy, cx, cy,
                        near_surface, far_surface)[-1]
    D, I = Knn.knn_tiles(pts.reshape(-1, 3), *tile_index, k=k)
    return idx, D.reshape(F, P, S, k), I.reshape(F, P, S, k)


def pack_union_cache(const, Wm, pmask, uids):
    FP, S = const["z"].shape
    u = uids.shape[-1]
    return torch.cat([const["z"], const["pts"].reshape(FP, S * 3),
                      const["rays_d"], const["d_gt"][:, None],
                      const["c_gt"], pmask.reshape(FP, S).float(),
                      Wm.reshape(FP, S * u),
                      Knn.pack_ids(uids.reshape(FP, u))], dim=1).contiguous()


def unique_bucket(n: int, cap: int) -> int:
    for u in (8192, 32768, 131072, 262144):
        if n <= u:
            return min(u, cap)
    u = 524288
    while u < n:
        u <<= 1
    return min(u, cap)


@torch.no_grad()
def compact_scene(cacheI, pos, geo, col, U):
    cap = pos.shape[0]
    flat = cacheI.reshape(-1)
    u = torch.unique(flat)
    uniq = torch.cat([u, torch.full((U - u.numel(),), cap, dtype=u.dtype,
                                    device=u.device)])
    remap = torch.searchsorted(uniq, flat).reshape(cacheI.shape)
    safe = torch.clamp(uniq, max=cap - 1)
    return uniq, remap, pos[safe], geo[safe], col[safe]


def pool_inside_thresh(cache_pix, depths, F_actual):
    F_max, _, W = depths.shape
    pj = torch.div(cache_pix, W, rounding_mode="floor")
    d_pool = depths[torch.arange(F_max, device=depths.device)[:, None], pj,
                    cache_pix % W]
    validf = torch.arange(F_max, device=depths.device)[:, None] < F_actual
    sd = torch.sort(torch.where(validf, d_pool, float("inf")).reshape(-1))[0]
    n_val = F_actual * cache_pix.shape[1]
    return torch.minimum(10.0 * sd[max((n_val - 1) // 2, 0)],
                         1.2 * sd[max(n_val - 1, 0)])


def exposure_rows(col_dec, expo_stack, expo_feat, F_actual, fid):
    F_max = expo_stack.shape[0]
    ef = expo_stack.clone()
    if expo_feat is not None:
        ef = torch.cat([ef[:F_actual - 1], expo_feat[None], ef[F_actual:]])
    rots, transs = Dec.exposure_affine(col_dec, ef)
    oh = (fid[:, None] == torch.arange(F_max, device=fid.device)[None, :]
          ).to(rots.dtype)
    return oh @ torch.cat([rots.reshape(F_max, 9), transs], dim=1)


def optimise(stage_loss, lr_tree_for, op, ost, gen, lr_table, geo_iters,
             n_rays, P, F_actual):
    """mapper.optimise on one device: each iteration draws n_rays cache
    slots (ray r on window frame r % F_actual), takes the stage loss and
    one Adam step.  Returns (op, ost, losses (n, 2) [geo, colour])."""
    dev = Opt.tree_leaves(op)[0].device
    fid = torch.arange(n_rays, device=dev) % F_actual
    losses = []
    for it in range(lr_table.shape[0]):
        with_color = it >= geo_iters
        slot = torch.randint(0, P, (n_rays,), generator=gen, device=dev)
        opg = Opt.tree_map(lambda t: t.detach().requires_grad_(), op)
        leaves = Opt.tree_leaves(opg)
        total, gl, cl = stage_loss(opg, fid, slot, with_color)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        gtree = Opt.tree_unflatten(opg, grads)
        op, ost = Opt.update(gtree, ost, Opt.tree_map(torch.detach, opg),
                             lr_tree_for(opg, lr_table[it]))
        losses.append(torch.stack([gl.detach(), cl.detach()]))
    return op, ost, torch.stack(losses).cpu().numpy()


def union_stage_loss(params, mcfg, rcfg, depths, cache_pix, packed, u_sz,
                     expo_stack, F_actual, use_exposure, w_color, level):
    """The union path's stage loss: the feature-row gather and
    ``maploss_plain`` (kernel #3's definition)."""
    P = cache_pix.shape[1]
    S = rcfg.N_surface
    C = mcfg.c_dim
    o = Dec.row_offsets(S, u_sz)
    inside_thresh = pool_inside_thresh(cache_pix, depths, F_actual)
    geo_flat = Dec.flatten_core(params[f"geo_{level}"]["core"])
    Bs = (params[f"geo_{level}"]["B"], params[f"col_{level}"]["B"])

    def loss(op, fid, slot, with_color):
        row = packed[fid * P + slot]
        d_gt = row[:, o["d_gt"]]
        uids = Knn.unpack_ids(row[:, o["uids"]:o["uids"] + u_sz])
        inside = d_gt <= inside_thresh
        n = row.shape[0]
        feat_v = op["feat"] if with_color else op["feat"][:, :C]
        dec = op.get("dec", {}).get(f"col_{level}", params[f"col_{level}"])
        uf = IT.gather_rows(feat_v, uids).reshape(n, -1)
        okf = ((d_gt > 0) & inside).float()[:, None]
        use_aff = bool(use_exposure) and with_color
        aff = (exposure_rows(dec, expo_stack, op.get("expo_feat"), F_actual,
                             fid) if use_aff
               else torch.zeros((n, 12), device=row.device))
        gl, cl = Dec.maploss_plain(
            uf, aff, Dec.flatten_core(dec["core"]), row, okf, geo_flat, Bs,
            mcfg.n_blocks, mcfg.skip, with_color, S, u_sz, C,
            float(rcfg.sigmoid_coef), not mcfg.encode_exposure, use_aff)
        if with_color:
            return gl + w_color * cl, gl, cl
        return gl, gl, torch.zeros((), device=row.device)

    def lr_tree_for(op, lrs):
        dev = op["feat"].device
        tree = {"feat": torch.cat([torch.full((C,), float(lrs[1]),
                                              device=dev),
                                   torch.full((C,), float(lrs[2]),
                                              device=dev)])}
        if "dec" in op:
            tree["dec"] = float(lrs[0])
        if "expo_feat" in op:
            tree["expo_feat"] = 0.001
        return tree

    return loss, lr_tree_for


def samples_stage_loss(params, mcfg, rcfg, colors, depths, c2ws, rq_map,
                       cache_pix, cacheD, cacheI, expo_stack, pos, F_actual,
                       fx, fy, cx, cy, use_exposure, opt_geo_dec, w_color,
                       level):
    """The per-sample path's stage loss (no BA): each ray renders through
    ``render_rays`` over its cached neighbours."""
    W = depths.shape[2]
    k = cacheD.shape[-1]
    inside_thresh = pool_inside_thresh(cache_pix, depths, F_actual)

    def loss(op, fid, slot, with_color):
        stage = f"{'color' if with_color else 'geometry'}_{level}"
        pr = params
        if "dec" in op and (with_color or opt_geo_dec):
            pr = dict(params, **op["dec"])
        idx = cache_pix[fid, slot]
        jj = torch.div(idx, W, rounding_mode="floor")
        ii = idx % W
        dirs = G.camera_dirs(ii.float(), jj.float(), fx, fy, cx, cy)
        rays_d = torch.einsum("nd,nkd->nk", dirs, c2ws[fid, :3, :3])
        rays_o = c2ws[fid, :3, 3]
        d_gt = depths[fid, jj, ii]
        kc = (cacheD[fid, slot].reshape(-1, k),
              cacheI[fid, slot].reshape(-1, k))
        depth, _unc, color, vmask = render_rays(
            pr, mcfg, rcfg, stage, rays_o, rays_d, d_gt, pos, pos.shape[0],
            op["geo"], op["col"], rq_map[fid, jj, ii], is_tracker=False,
            knn_cache=kc)
        mask = ((d_gt > 0) & vmask & torch.isfinite(depth)
                & (d_gt <= inside_thresh))
        gl = torch.sum(torch.where(mask, torch.abs(d_gt - depth), 0.0))
        if not with_color:
            return gl, gl, torch.zeros((), device=gl.device)
        if use_exposure:
            sel = exposure_rows(pr[f"col_{level}"], expo_stack,
                                op.get("expo_feat"), F_actual, fid)
            color = torch.sigmoid(torch.einsum(
                "nc,ncd->nd", color, sel[:, :9].reshape(-1, 3, 3))
                + sel[:, 9:])
        c_gt = colors[fid, jj, ii]
        cl = torch.sum(torch.where(mask[:, None], torch.abs(c_gt - color),
                                   0.0))
        return gl + w_color * cl, gl, cl

    def lr_tree_for(op, lrs):
        tree = {"geo": float(lrs[1]), "col": float(lrs[2])}
        if "dec" in op:
            tree["dec"] = float(lrs[0])
        if "expo_feat" in op:
            tree["expo_feat"] = 0.001
        return tree

    return loss, lr_tree_for


def _rays(ii, jj, c2w, cam):
    dirs = np.stack([(ii - cam["cx"]) / cam["fx"],
                     -(jj - cam["cy"]) / cam["fy"],
                     -np.ones_like(ii, np.float64)], -1).astype(np.float32)
    rays_d = (dirs @ c2w[:3, :3].T).astype(np.float32)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).astype(np.float32)
    return rays_o, rays_d


def _sample_valid(rng, depth, n):
    pool = IM.valid_pixel_pool(depth, 0, depth.shape[0], 0, depth.shape[1])
    sel = pool[rng.integers(0, pool.shape[0], size=n)]
    jj, ii = np.unravel_index(sel, depth.shape)
    return ii, jj


def add_points_for_frame(cfg, cam, rng, store, idx, color, depth, c2w,
                         prev_c2w, r_add, device):
    """Mapper.add_points_for_frame: the non-overlap and overlap batches."""
    m = cfg["mapping"]
    H, W = depth.shape

    def visible(rays_o, rays_d, depth_s):
        prev_w2c = torch.as_tensor(np.linalg.inv(prev_c2w),
                                   dtype=torch.float32, device=device)
        pts = torch.as_tensor(rays_o + rays_d * depth_s[:, None],
                              device=device)
        uv, _z = G.project_points(pts, prev_w2c, cam["fx"], cam["fy"],
                                  cam["cx"], cam["cy"])
        return ((uv[:, 0] < W) & (uv[:, 0] > 0) & (uv[:, 1] < H)
                & (uv[:, 1] > 0)).cpu().numpy()

    if idx == 0:
        med = float(np.median(depth[depth > 0])) if (depth > 0).any() \
            else 2.5
        n_add = int(np.clip(m["pixels_adding"] * (med / 2.5) ** 2,
                            m["pixels_adding"], m["pixels_adding"] * 3))
    else:
        n_add = m["pixels_adding"]
    ii, jj = _sample_valid(rng, depth, n_add)
    rays_o, rays_d = _rays(ii, jj, c2w, cam)
    depth_s = depth[jj, ii]
    total = 0
    if m["filter_before_add_points"] and idx != 0:
        mask_add = ~visible(rays_o, rays_d, depth_s)
        for level in ("fine", "mid"):
            n = store.add(rays_o, rays_d, depth_s, level,
                          r_add[level][jj, ii], valid=mask_add)
            total += n if level == "fine" else 0
        ii2, jj2 = _sample_valid(rng, depth, 1000)
        rays_o2, rays_d2 = _rays(ii2, jj2, c2w, cam)
        depth2 = depth[jj2, ii2]
        visible2 = visible(rays_o2, rays_d2, depth2)
        for level in ("fine", "mid"):
            n = store.add(rays_o2, rays_d2, depth2, level,
                          r_add[level][jj2, ii2], valid=visible2)
            total += n if level == "fine" else 0
    else:
        for level in ("fine", "mid"):
            n = store.add(rays_o, rays_d, depth_s, level,
                          r_add[level][jj, ii])
            total += n if level == "fine" else 0
    if m.get("pixels_based_on_color_grad", 0) > 0:
        raise ValueError("pixels_based_on_color_grad is not in the "
                         "reference")
    return int(total)


def map_call(cfg: dict, cam: dict, cap: dict, color, depth, idx: int,
             c2w, device, n_follow=None):
    """One mapped frame's call from its starting state ``cap`` (see
    ``benchmark.check``).  n_follow: stop after that many iterations of
    the mid level (0: after the insertion); None: the whole call, both
    levels, with the features written back.  Returns {"levels": {level:
    (count, pos (count, 3))} after insertion, "frame_pts_add", "n_joint",
    "window", "losses" (iterations run, 2) [geo, colour], and for a whole
    call "state": {level: (geo, col)} written back, "params", "expo"}."""
    m = cfg["mapping"]
    pc = cfg["pointcloud"]
    mcfg = Dec.ModelConfig.from_cfg(cfg)
    rcfg = RenderConfig.from_cfg(cfg, "sigmoid_coef_mapper")
    H, W = depth.shape
    rng = np.random.default_rng()
    rng.bit_generator.state = cap["mapper_rng"]
    mgen = torch.Generator(device=device)
    mgen.set_state(cap["mapper_gen"])
    sgen = torch.Generator(device=device)
    sgen.set_state(cap["store_gen"])
    store = Store(cfg, {lv: [t.clone() for t in cap["levels"][lv][:3]]
                        + [cap["levels"][lv][3]] for lv in cap["levels"]},
                  sgen)
    r_add, r_query = IM.dynamic_radii(color, pc["radius_hierarchy"],
                                      pc["radius_query_ratio"],
                                      pc["color_grad_threshold"])
    kfs = cap["keyframes"]
    win = int(m["mapping_window_size"]) * (2 if cap["n_img"] > 4000 else 1)
    if len(kfs) == 0:
        frames = []
    elif m["keyframe_selection_method"] == "global":
        num = win - 2
        frames = list(range(max(0, len(kfs) - 1 - num), len(kfs) - 1))
    else:
        frames = keyframe_selection_overlap(
            rng, depth, c2w, [kf["est_c2w"] for kf in kfs[:-1]], win - 2,
            cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    if len(kfs) > 0:
        frames = frames + [len(kfs) - 1]
    window = frames + [-1]
    frame_pts_add = add_points_for_frame(
        cfg, cam, rng, store, idx, color, depth, c2w, cap["prev_c2w"], r_add,
        device)
    init = idx == 0
    n_joint = int(m["iters_first"] if init else m["iters"])
    if m["more_iters_when_adding"] and idx > 0:
        n = int(np.clip(n_joint * frame_pts_add / 300,
                        int(m["min_iter_ratio"] * n_joint), 2 * n_joint))
        n_joint = (n if m.get("exact_iter_counts")
                   else bucket_iters(n, int(m["iters"])))
    schedules = build_schedule(
        n_joint, float(m["mid_iter_ratio"]), float(m["geo_iter_ratio"]), init,
        int(m["geo_iter_first"]), {"init": m["init"], "stage": m["stage"]})
    out = {"levels": {lv: (store.levels[lv][3],
                           store.levels[lv][0][:store.levels[lv][3]].clone())
                      for lv in store.levels},
           "frame_pts_add": frame_pts_add, "n_joint": n_joint,
           "window": window}
    if n_follow is None:
        out["init_state"] = {lv: (store.levels[lv][1].clone(),
                                  store.levels[lv][2].clone())
                             for lv in store.levels}
    if n_follow == 0:
        return out
    # the window's stacked frames, padded to window + 2 slots
    F_actual = len(window)
    F_max = max(win + 2, F_actual)
    E = int(cfg["model"]["exposure_dim"])
    cols, deps, rqs, pools = [], [], {"mid": [], "fine": []}, []
    c2ws = np.tile(np.eye(4, dtype=np.float32), (F_max, 1, 1))
    pool_lens = np.ones((F_max,), np.int64)
    expo = np.zeros((F_max, E), np.float32)
    for slot, f in enumerate(window):
        if f == -1:
            col_f, dep_f = color, depth
            rq_f = {"mid": r_query["mid"], "fine": r_query["fine"]}
            c2ws[slot] = c2w
            expo[slot] = np.asarray(cap["exposure_feat"])
        else:
            kf = kfs[f]
            col_f, dep_f = kf["color"], kf["depth"]
            rq_f = {"mid": kf["r_query_mid"], "fine": kf["r_query_fine"]}
            c2ws[slot] = kf["est_c2w"]
            expo[slot] = kf["exposure_feat"]
        pj, plen = valid_pixel_pool_padded(dep_f, H, W)
        cols.append(torch.as_tensor(col_f, device=device))
        deps.append(torch.as_tensor(dep_f, device=device))
        for lv in rqs:
            rqs[lv].append(torch.as_tensor(rq_f[lv], device=device))
        pools.append(torch.as_tensor(pj, device=device))
        pool_lens[slot] = plen
    pad = F_max - F_actual
    z2 = torch.zeros((H, W), device=device)
    colors = torch.stack(cols + [torch.zeros((H, W, 3), device=device)] * pad)
    depths = torch.stack(deps + [z2] * pad)
    rq_t = {lv: torch.stack(rqs[lv] + [z2] * pad) for lv in rqs}
    pools_t = torch.stack(pools + [torch.zeros((H * W,), dtype=torch.int64,
                                               device=device)] * pad)
    pool_lens_t = torch.as_tensor(pool_lens, device=device)
    c2ws_t = torch.as_tensor(c2ws, device=device)
    expo_t = torch.as_tensor(expo, device=device)
    new_params = dict(cap["params"])
    new_expo = np.asarray(cap["exposure_feat"])
    n_rays = int(m["pixels"])
    P = int(m.get("pixels_knn_cache", max(2000, 4 * (n_rays // max(
        1, F_actual)))))
    u_max = int(m.get("union_size", 8))
    use_exposure = bool(cfg["model"]["encode_exposure"])
    use_union = not (m["BA"] or mcfg.encode_rel_pos_in_col
                     or mcfg.encode_rel_pos_in_geo)
    opt_geo_dec = not (m["fix_geo_decoder_mid"] and m["fix_geo_decoder_fine"])
    S, k = rcfg.N_surface, rcfg.nn_num
    C = mcfg.c_dim
    losses_all = []
    shared_t = None
    for level in ("mid", "fine"):
        stage_ids, lr_table = schedules[level]
        if stage_ids.size == 0:
            continue
        if n_follow is not None:
            lr_table = lr_table[:n_follow]
        pos, geo, col, count = store.levels[level]
        capacity = pos.shape[0]
        if use_union:
            cache_pix, cacheI, cacheWm, cachePm, const = union_cache(
                mgen, depths, c2ws_t, pools_t, pool_lens_t, rq_t[level],
                store.index(level), capacity, P, S, k, u_max, W, cam["fx"],
                cam["fy"], cam["cx"], cam["cy"], rcfg.near_end_surface,
                rcfg.far_end_surface, mcfg.min_nn_num, mcfg.weighting,
                colors, rcfg.fix_interval, int(m.get("knn_probe", 12)))
        else:
            cache_pix, cacheD, cacheI = knn_cache(
                mgen, depths, c2ws_t, pools_t, pool_lens_t,
                store.index(level), P, S, k, W, cam["fx"], cam["fy"],
                cam["cx"], cam["cy"], rcfg.near_end_surface,
                rcfg.far_end_surface)
        U = unique_bucket(int(torch.unique(cacheI.reshape(-1)).numel()),
                          capacity)
        uniq, cacheI_c, pos_c, geo_c, col_c = compact_scene(cacheI, pos, geo,
                                                            col, U)
        op = ({"feat": torch.cat([geo_c, col_c], 1)} if use_union
              else {"geo": geo_c, "col": col_c})
        dec = {name: Opt.tree_map(torch.clone, new_params[name])
               for name, on in ((f"col_{level}", not m["fix_color_decoder"]),
                                (f"geo_{level}", opt_geo_dec)) if on}
        if dec:
            op["dec"] = dec
        if use_exposure:
            op["expo_feat"] = torch.as_tensor(np.asarray(new_expo),
                                              dtype=torch.float32,
                                              device=device)
        ost = Opt.init(op)
        if shared_t is not None:
            ost["t"] = shared_t["t"]
            if "expo_feat" in ost["m"] and "m_expo" in shared_t:
                ost["m"]["expo_feat"] = shared_t["m_expo"]
                ost["v"]["expo_feat"] = shared_t["v_expo"]
        n_geo = int(np.sum(stage_ids == 0))
        lv_params = dict(new_params)
        if use_union:
            packed = pack_union_cache(const, cacheWm, cachePm, cacheI_c)
            loss, lr_for = union_stage_loss(lv_params, mcfg, rcfg, depths,
                                            cache_pix, packed, u_max, expo_t,
                                            F_actual, use_exposure,
                                            float(m["w_color_loss"]), level)
        else:
            loss, lr_for = samples_stage_loss(
                lv_params, mcfg, rcfg, colors, depths, c2ws_t, rq_t[level],
                cache_pix, cacheD, cacheI_c, expo_t, pos_c, F_actual,
                cam["fx"], cam["fy"], cam["cx"], cam["cy"], use_exposure,
                opt_geo_dec, float(m["w_color_loss"]), level)
        op, ost, losses = optimise(loss, lr_for, op, ost, mgen, lr_table,
                                   n_geo, n_rays, P, F_actual)
        losses_all.append(losses)
        if n_follow is not None:
            break
        keep = uniq < capacity
        if use_union:
            geo[uniq[keep]] = op["feat"][:, :C][keep]
            col[uniq[keep]] = op["feat"][:, C:][keep]
        else:
            geo[uniq[keep]] = op["geo"][keep]
            col[uniq[keep]] = op["col"][keep]
        new_params.update(op.get("dec", {}))
        if use_exposure:
            new_expo = op["expo_feat"].detach().cpu().numpy()
        shared_t = {"t": ost["t"]}
        if "expo_feat" in ost["m"]:
            shared_t["m_expo"] = ost["m"]["expo_feat"]
            shared_t["v_expo"] = ost["v"]["expo_feat"]
    out["losses"] = np.concatenate(losses_all, axis=0)
    if n_follow is None:
        out["state"] = {lv: (store.levels[lv][1], store.levels[lv][2])
                        for lv in store.levels}
        out["params"] = new_params
        out["expo"] = new_expo
    return out
