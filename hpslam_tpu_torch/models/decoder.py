"""NICER decoder family (port of hpslam_tpu/models/decoder.py).

Parameters use the reference's dict-of-tensors layout, so converted JAX
weights carry over one to one (``convert.py``):
  geo_{mid,fine}: {"B" (3, geo_embed), "core": {"layers": [{"w", "b"}]*n,
                   "fc_c": [{"w", "b"}]*n, "out": {"w", "b"}}}
  col_{mid,fine}: {"B" (3, col_embed), "core": ..., "rel_B", "mlp_neighbor",
                   optional "exposure": {"l1", "l2"}}
Weights are (fan_in, fan_out); a layer is x @ w + b.

The plain trunks are here; ``fused_geo`` / ``fused_color_pair`` run both
trunks through the fused trunk kernels of ops/fused_mlp.py
(``nicer_fused_geo`` / ``nicer_fused_color``), which ``eval_stage`` takes
where ``fused_usable``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ..ops import interpolate as IT

Params = Dict[str, Any]


def _resolve_fused(v) -> bool:
    """'auto' -> on: the port's mapping-loss path has a kernel on CUDA and
    its plain version on the CPU."""
    return True if v == "auto" else bool(v)


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
    mm_bf16: bool = False
    fused_mlp: bool = False
    fused_composite: bool = False

    @classmethod
    def from_cfg(cls, cfg: dict) -> "ModelConfig":
        m = cfg["model"]
        pc = cfg["pointcloud"]
        return cls(
            c_dim=m["c_dim"],
            mm_bf16=m.get("mm_bf16", False),
            fused_mlp=_resolve_fused(m.get("fused_mlp", "auto")),
            fused_composite=_resolve_fused(m.get("fused_composite", "auto")),
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


# ---------------------------------------------------------------------------
# initialisers (torch nn.Linear / DenseLayer distributions)

def _uniform(g, shape, bound, device):
    return (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * bound


def _linear_default(g, fan_in, fan_out, device):
    bound = 1.0 / math.sqrt(fan_in)
    return {"w": _uniform(g, (fan_in, fan_out), bound, device),
            "b": _uniform(g, (fan_out,), bound, device)}


def _dense(g, fan_in, fan_out, gain_mode, device):
    gain = math.sqrt(2.0) if gain_mode == "relu" else 1.0
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return {"w": _uniform(g, (fan_in, fan_out), bound, device),
            "b": torch.zeros((fan_out,), device=device)}


def _xavier(g, fan_in, fan_out, device):
    return {"w": _uniform(g, (fan_in, fan_out),
                          math.sqrt(6.0 / (fan_in + fan_out)), device),
            "b": _uniform(g, (fan_out,), 1.0 / math.sqrt(fan_in), device)}


def _normal001(g, fan_in, fan_out, device):
    return {"w": torch.randn((fan_in, fan_out), generator=g,
                             device=device) * 0.01,
            "b": _uniform(g, (fan_out,), 1.0 / math.sqrt(fan_in), device)}


def init_mlp_core(g, cfg: ModelConfig, hidden: int, embed_in: int,
                  out_dim: int, out_gain: str, device):
    layers = []
    for i in range(cfg.n_blocks):
        if i == 0:
            in_dim = embed_in
        elif i == cfg.skip + 1:
            in_dim = hidden + embed_in
        else:
            in_dim = hidden
        layers.append(_dense(g, in_dim, hidden, "relu", device))
    fc_c = [_linear_default(g, cfg.c_dim, hidden, device)
            for _ in range(cfg.n_blocks)]
    out = _dense(g, hidden, out_dim, out_gain, device)
    return {"layers": layers, "fc_c": fc_c, "out": out}


def init_geo_decoder(g, cfg: ModelConfig, device) -> Params:
    p = {"B": torch.randn((3, cfg.geo_embed), generator=g, device=device)
         * cfg.geo_scale,
         "core": init_mlp_core(g, cfg, cfg.hidden_geo, cfg.geo_embed, 1,
                               "relu", device)}
    if cfg.encode_rel_pos_in_geo:
        p["rel_B"] = torch.randn((3, cfg.rel_embed), generator=g,
                                 device=device) * cfg.rel_scale
        p["mlp_neighbor"] = {
            "l1": _xavier(g, cfg.c_dim + 2 * cfg.rel_embed, cfg.hidden_col,
                          device),
            "l2": _xavier(g, cfg.hidden_col, cfg.c_dim, device)}
    return p


def init_color_decoder(g, cfg: ModelConfig, device) -> Params:
    embed_in = 2 * cfg.col_embed
    if cfg.use_view_direction:
        embed_in += 2 * cfg.col_embed if cfg.encode_viewd else 3
    p = {"B": torch.randn((3, cfg.col_embed), generator=g, device=device)
         * cfg.col_scale,
         "core": init_mlp_core(g, cfg, cfg.hidden_col, embed_in, 3, "linear",
                               device),
         "rel_B": torch.randn((3, cfg.rel_embed), generator=g,
                              device=device) * cfg.rel_scale,
         "mlp_neighbor": {
             "l1": _xavier(g, cfg.c_dim + 2 * cfg.rel_embed, cfg.hidden_col,
                           device),
             "l2": _xavier(g, cfg.hidden_col, cfg.c_dim, device)}}
    if cfg.use_view_direction and cfg.encode_viewd:
        p["view_B"] = torch.randn((3, cfg.col_embed), generator=g,
                                  device=device) * cfg.col_scale
    if cfg.use_normals:
        p["normal_B"] = torch.randn((2, cfg.col_embed), generator=g,
                                    device=device) * cfg.col_scale
    if cfg.encode_exposure:
        p["exposure"] = {
            "l1": _normal001(g, cfg.exposure_dim, cfg.hidden_col, device),
            "l2": _normal001(g, cfg.hidden_col, 12, device)}
    return p


def init_nicer(g: torch.Generator, cfg: ModelConfig, device) -> Params:
    """All four decoders, drawn from ``g`` (a generator on ``device``)."""
    return {"geo_mid": init_geo_decoder(g, cfg, device),
            "geo_fine": init_geo_decoder(g, cfg, device),
            "col_mid": init_color_decoder(g, cfg, device),
            "col_fine": init_color_decoder(g, cfg, device)}


# ---------------------------------------------------------------------------
# forward passes

def _apply_linear(p, x):
    return x @ p["w"] + p["b"]


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


def _bf16(x):
    """x rounded to bfloat16 and held in float32."""
    return x.to(torch.bfloat16).float()


def _apply_linear_bf16(p, x):
    """x @ w + b with bf16 operands and f32 accumulation: each operand is
    rounded to bfloat16 and the product taken in float32 (the product of
    two bf16 values is exact in f32), on the CPU and the card alike."""
    return _bf16(x) @ _bf16(p["w"]) + p["b"]


def mlp_trunk(core: Params, cfg: ModelConfig, embedded, c, actvn):
    """Trunk with skip concat after block ``skip`` and per-block additive
    feature injection h = act(h W + b) + c F + f.

    mm_bf16: bf16 operands with f32 accumulation and the f32 bias, the
    activation in f32, each block's output (with its feature term) stored
    as bfloat16, the skip concat with the bf16 embedding, the output layer
    in f32 (the reference's _mlp_trunk)."""
    if cfg.mm_bf16:
        emb16 = embedded.to(torch.bfloat16)
        c16 = c.to(torch.bfloat16)
        h = emb16
        for i, layer in enumerate(core["layers"]):
            h = actvn(_apply_linear_bf16(layer, h))
            h = (h + _apply_linear_bf16(core["fc_c"][i], c16)).to(
                torch.bfloat16)
            if i == cfg.skip:
                h = torch.cat([emb16, h], dim=-1)
        return _apply_linear_bf16(core["out"], h)
    h = embedded
    for i, layer in enumerate(core["layers"]):
        h = actvn(_apply_linear(layer, h))
        h = h + c @ core["fc_c"][i]["w"] + core["fc_c"][i]["b"]
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
            out = torch.sigmoid(out @ rot + trans)
    else:
        out = torch.sigmoid(out)
    return out


def valid_ray_mask(has_neighbors, n_pts_per_ray: int, n_surface: int):
    """Ray valid iff >= N_surface//2+1 of its samples have neighbours."""
    per_ray = torch.sum(has_neighbors.reshape(-1, n_pts_per_ray).to(
        torch.int64), dim=1)
    return per_ray >= int(n_surface / 2 + 1)


def fused_usable(cfg: ModelConfig, views_d=None, normals=None) -> bool:
    return (cfg.fused_mlp and not cfg.encode_rel_pos_in_geo
            and not cfg.encode_rel_pos_in_col
            and not cfg.use_view_direction and not cfg.use_normals
            and views_d is None and normals is None)


def fused_geo(p_dec: Params, cfg: ModelConfig, p, c_geo,
              need_dp: bool = True):
    """apply_geo through the fused trunk kernels (geometry core frozen).
    need_dp=False skips the embedding backward when the sample positions
    are constants (mapper union path)."""
    from ..ops import fused_mlp as FM
    return FM.nicer_fused_geo(p, c_geo, FM.flatten_core(p_dec["core"]),
                              p_dec["B"], cfg.n_blocks, cfg.skip, need_dp)


def fused_color_pair(geo_dec: Params, col_dec: Params, cfg: ModelConfig,
                     p, c_geo, c_col, exposure_feat=None,
                     need_dp: bool = True, need_wgrads: bool = True):
    """apply_geo + apply_color through one fused trunk kernel pair: (occ
    (n,), rgb (n, 3)), with apply_color's exposure / sigmoid tail (raw
    output when the exposure is deferred to the caller)."""
    from ..ops import fused_mlp as FM
    occ, out = FM.nicer_fused_color(
        p, c_geo, c_col, FM.flatten_core(geo_dec["core"]),
        FM.flatten_core(col_dec["core"]), (geo_dec["B"], col_dec["B"]),
        cfg.n_blocks, cfg.skip, need_dp, need_wgrads)
    if cfg.encode_exposure:
        if exposure_feat is not None:
            rot, trans = exposure_affine(col_dec, exposure_feat)
            out = torch.sigmoid(out @ rot + trans)
    else:
        out = torch.sigmoid(out)
    return occ, out


def eval_stage(params: Params, cfg: ModelConfig, stage: str, p, D, I,
               geo_feats, col_feats, cloud_pos, r_query, n_pts_per_ray: int,
               is_tracker: bool = False, views_d=None, normals=None,
               exposure_feat=None, cat_feats=None, dense_cache=None):
    """One render stage at sample positions; the fused trunks where
    ``fused_usable``, else the plain ones.
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
        if fused_usable(cfg):
            occ = fused_geo(geo_dec, cfg, p, c_geo)
        else:
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
    if fused_usable(cfg, views_d, normals):
        occ, rgb = fused_color_pair(geo_dec, col_dec, cfg, p, c_geo, c_col,
                                    exposure_feat=exposure_feat)
    else:
        occ = apply_geo(geo_dec, cfg, p, c_geo)
        rgb = apply_color(col_dec, cfg, p, c_col, views_d=views_d,
                          normals=normals, exposure_feat=exposure_feat)
    raw = torch.cat([rgb, occ[..., None]], dim=-1)
    return raw, vmask, has
