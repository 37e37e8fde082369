"""Frozen copy of the plain path of hpslam_tpu_torch/models/decoder.py
(and of ops/fused_mlp.py's plain mapping loss) for the benchmark's
reference: the NICER decoders on plain float32 trunks, the feature
interpolation, and ``maploss_plain``, the definition kernel #3 computes.
Parameters use the port's layout: weights (fan_in, fan_out), a layer is
x @ w + b.  Imports nothing of the program.
"""
from __future__ import annotations

import contextvars
import dataclasses
import math
from typing import Any, Dict

import torch

from . import interpolate as IT

Params = Dict[str, Any]

# the control's precision: with "tf32" every decoder product rounds its
# operands to TensorFloat-32 (10 mantissa bits) before a float32 product,
# as the tensor cores do with TF32 on; "f32" is the reference itself
PRECISION = contextvars.ContextVar("reference_precision", default="f32")


def _tf32(x):
    """x rounded to the nearest TensorFloat-32 value (ties away from
    zero), held in float32; gradients pass straight through."""
    d = x.detach().contiguous()
    r = ((d.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - d)


def mm(a, b):
    if PRECISION.get() == "tf32":
        return _tf32(a) @ _tf32(b)
    return a @ b


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    c_dim: int = 32
    hidden_geo: int = 32
    hidden_col: int = 128
    n_blocks: int = 5
    skip: int = 2
    geo_embed: int = 93
    geo_scale: float = 25.0
    col_embed: int = 20
    col_scale: float = 32.0
    rel_embed: int = 10
    rel_scale: float = 32.0
    exposure_dim: int = 8
    min_nn_num: int = 2
    nn_num: int = 8
    N_surface: int = 5
    weighting: str = "distance"
    encode_rel_pos_in_col: bool = False
    encode_rel_pos_in_geo: bool = False
    encode_exposure: bool = False
    encode_viewd: bool = False
    use_view_direction: bool = False
    use_normals: bool = False

    @classmethod
    def from_cfg(cls, cfg: dict) -> "ModelConfig":
        m = cfg["model"]
        pc = cfg["pointcloud"]
        return cls(
            c_dim=m["c_dim"],
            exposure_dim=m["exposure_dim"],
            min_nn_num=pc["min_nn_num"],
            nn_num=pc["nn_num"],
            N_surface=cfg["rendering"]["N_surface"],
            weighting=pc["nn_weighting"],
            encode_rel_pos_in_col=m["encode_rel_pos_in_col"],
            encode_rel_pos_in_geo=m.get("encode_rel_pos_in_geo", False),
            encode_exposure=m["encode_exposure"],
            encode_viewd=m.get("encode_viewd", False),
            use_view_direction=cfg.get("use_view_direction", False),
            use_normals=cfg.get("use_normals", False),
        )


def _apply_linear(p, x):
    return mm(x, p["w"]) + p["b"]


def softplus100(x):
    """Softplus(beta=100) with torch's threshold-20 clamp."""
    bx = 100.0 * x
    return torch.where(bx > 20.0, x,
                       torch.log1p(torch.exp(torch.clamp(bx, max=20.0)))
                       / 100.0)


def fourier_proj(x, B):
    """(2 pi x) @ B for a K=3 (or 2) B, as explicit products and sums in a
    fixed order: the projection reaches 1e3 radians, so its rounding sets
    the embedding's, and the mapping-loss kernel uses the same order."""
    tx = x * (2.0 * math.pi)
    proj = tx[..., 0:1] * B[0]
    for d in range(1, B.shape[0]):
        proj = proj + tx[..., d:d + 1] * B[d]
    return proj


def fourier_features(x, B, concat_cos: bool):
    proj = fourier_proj(x, B)
    if concat_cos:
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
    return torch.sin(proj)


def mlp_trunk(core: Params, cfg: ModelConfig, embedded, c, actvn):
    """Trunk with skip concat after block ``skip`` and per-block additive
    feature injection h = act(h W + b) + c F + f (float32)."""
    h = embedded
    for i, layer in enumerate(core["layers"]):
        h = actvn(_apply_linear(layer, h))
        h = h + mm(c, core["fc_c"][i]["w"]) + core["fc_c"][i]["b"]
        if i == cfg.skip:
            h = torch.cat([embedded, h], dim=-1)
    return _apply_linear(core["out"], h)


def _neighbor_transform(p_dec: Params, cfg: ModelConfig, neighbor_feats,
                        neighbor_rel_pos):
    Q, k, _ = neighbor_feats.shape
    emb = fourier_features(neighbor_rel_pos.reshape(-1, 3), p_dec["rel_B"],
                           True).reshape(Q, k, 2 * cfg.rel_embed)
    x = torch.cat([emb, neighbor_feats], dim=-1)
    mlpn = p_dec["mlp_neighbor"]
    x = softplus100(_apply_linear(mlpn["l1"], x))
    return _apply_linear(mlpn["l2"], x)


def interpolate_level_feats(p_dec: Params, cfg: ModelConfig, p, D, I, feats,
                            cloud_pos, r_query, diff_pos: bool,
                            encode_rel_pos: bool):
    weights, has = IT.interp_weights(D, I, p, cloud_pos, r_query,
                                     cfg.min_nn_num, cfg.weighting, diff_pos)
    if encode_rel_pos:
        # the row gather's backward is the deterministic index_add_rows
        nf = IT.gather_rows(feats, I)
        rel = cloud_pos[I] - p[:, None, :]
        nf = _neighbor_transform(p_dec, cfg, nf, rel)
        c = torch.sum(weights * nf, dim=1)
        c = torch.where(has[:, None], c, torch.zeros_like(c))
    else:
        c = IT.weighted_gather(feats, I, weights, has)
    return c, has


def apply_geo(p_dec: Params, cfg: ModelConfig, p, c):
    """Occupancy logit (N,); ReLU trunk."""
    emb = fourier_features(p, p_dec["B"], concat_cos=False)
    return mlp_trunk(p_dec["core"], cfg, emb, c, torch.relu)[..., 0]


def exposure_affine(p_dec: Params, exposure_feat):
    """8-d latent -> (3x3 rot, 3 trans) colour affine."""
    e = p_dec["exposure"]
    h = softplus100(_apply_linear(e["l1"], exposure_feat))
    aff = _apply_linear(e["l2"], h)
    return aff[..., :9].reshape(aff.shape[:-1] + (3, 3)), aff[..., 9:]


def apply_color(p_dec: Params, cfg: ModelConfig, p, c, views_d=None,
                normals=None, exposure_feat=None):
    """RGB (N, 3); Softplus(100) trunk, sigmoid unless the exposure affine is
    deferred to the caller."""
    emb = fourier_features(p, p_dec["B"], concat_cos=True)
    if cfg.use_normals and normals is not None:
        emb = torch.cat([emb, fourier_features(normals, p_dec["normal_B"],
                                               True)], -1)
    elif cfg.use_view_direction and views_d is not None:
        v = views_d / torch.clamp(torch.linalg.norm(views_d, dim=-1,
                                                    keepdim=True), min=1e-12)
        if cfg.encode_viewd:
            v = fourier_features(v, p_dec["view_B"], True)
        emb = torch.cat([emb, v], -1)
    out = mlp_trunk(p_dec["core"], cfg, emb, c, softplus100)
    if cfg.encode_exposure:
        if exposure_feat is not None:
            rot, trans = exposure_affine(p_dec, exposure_feat)
            out = torch.sigmoid(mm(out, rot) + trans)
    else:
        out = torch.sigmoid(out)
    return out


def valid_ray_mask(has_neighbors, n_pts_per_ray: int, n_surface: int):
    """Ray valid iff >= N_surface//2+1 of its samples have neighbours."""
    per_ray = torch.sum(has_neighbors.reshape(-1, n_pts_per_ray).to(
        torch.int64), dim=1)
    return per_ray >= int(n_surface / 2 + 1)


def eval_stage(params: Params, cfg: ModelConfig, stage: str, p, D, I,
               geo_feats, col_feats, cloud_pos, r_query, n_pts_per_ray: int,
               is_tracker: bool = False, views_d=None, normals=None,
               exposure_feat=None, cat_feats=None, dense_cache=None):
    """One render stage at sample positions on the plain trunks.
    Returns raw (N, 4), valid_ray (N_rays,), point_mask (N,)."""
    level = "mid" if stage.endswith("_mid") else "fine"
    geo_dec = params[f"geo_{level}"]
    if dense_cache is not None:
        if not is_tracker or cfg.encode_rel_pos_in_geo \
                or cfg.encode_rel_pos_in_col:
            raise ValueError("dense_cache: tracker-mode plain feature "
                             "variant only")
        cpos, cfeat = dense_cache

    if stage.startswith("geometry"):
        if dense_cache is not None:
            weights, has = IT.interp_weights(
                D, I, p, cloud_pos, r_query, cfg.min_nn_num, cfg.weighting,
                diff_pos=True, neighbor_pos=cpos)
            c_geo = IT.weighted_dense(cfeat[..., :cfg.c_dim], weights, has)
        else:
            c_geo, has = interpolate_level_feats(
                geo_dec, cfg, p, D, I, geo_feats, cloud_pos, r_query,
                diff_pos=is_tracker, encode_rel_pos=cfg.encode_rel_pos_in_geo)
        occ = apply_geo(geo_dec, cfg, p, c_geo)
        vmask = valid_ray_mask(has, n_pts_per_ray, cfg.N_surface)
        raw = torch.cat([torch.zeros(p.shape[:-1] + (3,), device=p.device),
                         occ[..., None]], dim=-1)
        return raw, vmask, has

    col_dec = params[f"col_{level}"]
    if dense_cache is not None:
        weights, has = IT.interp_weights(
            D, I, p, cloud_pos, r_query, cfg.min_nn_num, cfg.weighting,
            diff_pos=True, neighbor_pos=cpos)
        c_all = IT.weighted_dense(cfeat, weights, has).float()
        c_geo, c_col = c_all[:, :cfg.c_dim], c_all[:, cfg.c_dim:]
    elif not (cfg.encode_rel_pos_in_geo or cfg.encode_rel_pos_in_col):
        weights, has = IT.interp_weights(
            D, I, p, cloud_pos, r_query, cfg.min_nn_num, cfg.weighting,
            is_tracker)
        cat = (cat_feats if cat_feats is not None
               else torch.cat([geo_feats, col_feats], dim=1))
        c_all = IT.weighted_gather(cat, I, weights, has).float()
        c_geo, c_col = c_all[:, :cfg.c_dim], c_all[:, cfg.c_dim:]
    else:
        c_geo, has = interpolate_level_feats(
            geo_dec, cfg, p, D, I, geo_feats, cloud_pos, r_query,
            diff_pos=is_tracker, encode_rel_pos=cfg.encode_rel_pos_in_geo)
        c_col, _ = interpolate_level_feats(
            col_dec, cfg, p, D, I, col_feats, cloud_pos, r_query,
            diff_pos=is_tracker, encode_rel_pos=cfg.encode_rel_pos_in_col)
    vmask = valid_ray_mask(has, n_pts_per_ray, cfg.N_surface)
    occ = apply_geo(geo_dec, cfg, p, c_geo)
    rgb = apply_color(col_dec, cfg, p, c_col, views_d=views_d,
                      normals=normals, exposure_feat=exposure_feat)
    raw = torch.cat([rgb, occ[..., None]], dim=-1)
    return raw, vmask, has


def flatten_core(core) -> list:
    """[W_i, b_i]*n + [F_i, f_i]*n + [Wout, bout] (the kernels' order)."""
    out = []
    for layer in core["layers"]:
        out += [layer["w"], layer["b"]]
    for fc in core["fc_c"]:
        out += [fc["w"], fc["b"]]
    return out + [core["out"]["w"], core["out"]["b"]]


def row_offsets(S: int, u: int) -> dict:
    return {"z": 0, "pts": S, "rays_d": 4 * S, "d_gt": 4 * S + 3,
            "c_gt": 4 * S + 4, "pm": 4 * S + 7, "wm": 5 * S + 7,
            "uids": 5 * S + 7 + S * u}


def _trunk_saved(e, c, flat, n_blocks: int, skip: int, act):
    """One trunk, skip concat after block ``skip`` and per-block feature
    injection h = act(h W + b) + c F + f, with the residuals its backward
    needs: (out, (pre-activations, layer inputs, last hidden))."""
    h = e
    a_s, x_s = [], []
    for i in range(n_blocks):
        W, b = flat[2 * i], flat[2 * i + 1]
        F, f = flat[2 * n_blocks + 2 * i], flat[2 * n_blocks + 2 * i + 1]
        x_s.append(h)
        a = mm(h, W) + b
        a_s.append(a)
        h = act(a) + mm(c, F) + f
        if i == skip:
            h = torch.cat([e, h], dim=-1)
    return mm(h, flat[-2]) + flat[-1], (a_s, x_s, h)


def _trunk(e, c, flat, n_blocks: int, skip: int, act):
    return _trunk_saved(e, c, flat, n_blocks, skip, act)[0]


def maploss_plain(uf, aff, col_flat, row, okf, geo_flat, Bs, n_blocks: int,
                  skip: int, with_color: bool, S: int, u: int, C: int,
                  coef: float, sigmoid_rgb: bool, use_affine: bool):
    """Plain PyTorch version of the mapping loss: (geo_loss, col_loss)."""
    Bg, Bc = Bs
    n = row.shape[0]
    o = row_offsets(S, u)
    z = row[:, o["z"]:o["z"] + S]
    pts = row[:, o["pts"]:o["pts"] + 3 * S].reshape(n, S, 3)
    d_gt = row[:, o["d_gt"]]
    c_gt = row[:, o["c_gt"]:o["c_gt"] + 3]
    pm = row[:, o["pm"]:o["pm"] + S] > 0.5
    Wm = row[:, o["wm"]:o["wm"] + S * u].reshape(n, S, u)
    fstride = 2 * C if with_color else C
    ufr = uf.reshape(n, u, fstride)
    cg = torch.where(pm[..., None],
                     torch.einsum("nsu,nuc->nsc", Wm, ufr[..., :C]), 0.0)
    p = pts.reshape(n * S, 3)
    eg = fourier_features(p, Bg, concat_cos=False)
    occ = _trunk(eg, cg.reshape(n * S, C), geo_flat, n_blocks, skip,
                 torch.relu)[:, 0].reshape(n, S)
    if with_color:
        cc = torch.where(pm[..., None],
                         torch.einsum("nsu,nuc->nsc", Wm, ufr[..., C:]), 0.0)
        ec = fourier_features(p, Bc, concat_cos=True)
        rgb = _trunk(ec, cc.reshape(n * S, C), col_flat, n_blocks, skip,
                     softplus100).reshape(n, S, 3)
        if sigmoid_rgb:
            rgb = torch.sigmoid(rgb)
    else:
        rgb = torch.zeros((n, S, 3), dtype=row.dtype, device=row.device)
    occ_f = torch.where(pm, occ, -100.0)
    a = torch.sigmoid(coef * occ_f)
    ts, t_run = [], torch.ones_like(a[:, 0])
    for s in range(S):
        ts.append(t_run)
        t_run = t_run * ((1.0 - a[:, s]) + 1e-10)
    w = a * torch.stack(ts, 1)
    wsum = torch.sum(w, 1) + 1e-10
    depth = torch.sum(w * z, 1) / wsum
    color_raw = torch.sum(w[..., None] * rgb, 1) / wsum[:, None]
    if use_affine and with_color:
        lin = torch.stack([
            color_raw[:, 0] * aff[:, d] + color_raw[:, 1] * aff[:, 3 + d]
            + color_raw[:, 2] * aff[:, 6 + d] + aff[:, 9 + d]
            for d in range(3)], 1)
        color = torch.sigmoid(lin)
    else:
        color = color_raw
    vmask = torch.sum(pm.to(torch.int64), 1) >= int(S / 2 + 1)
    mask = (okf[:, 0] > 0.5) & vmask & torch.isfinite(depth)
    gl = torch.sum(torch.where(mask, torch.abs(d_gt - depth), 0.0))
    if with_color:
        cl = torch.sum(torch.where(mask[:, None], torch.abs(c_gt - color),
                                   0.0))
    else:
        cl = torch.zeros((), dtype=row.dtype, device=row.device)
    return gl, cl
