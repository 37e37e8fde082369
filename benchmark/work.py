"""Operations and bytes of the work, counted from the problem's shapes.

Frozen copies of ``chip_smoke.py``'s counts (``trunk_flops``,
``maploss_work``, ``trackloss_work``, ``bound_ms``) and the H100's
published peaks, plus the counts the benchmark adds: the row top-k's
selection (#1), the per-sample mapping iteration and a tracking iteration
on the plain render.  A count depends on shapes only, never on which
kernel runs the work, so a roofline or an MFU reads the same work whatever
implementation a later change brings.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time: bytes over the memory rate or operations over the
    float32 rate, whichever is larger (chip_smoke.bound_ms, in seconds)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def widths(cfg: dict) -> dict:
    w = cfg["widths"]
    return {"C": int(cfg["model"]["c_dim"]), "nb": int(w["n_blocks"]),
            "skip": int(w["skip"]), "hg": int(w["hidden_geo"]),
            "hc": int(w["hidden_col"]), "eg": int(w["geo_embed"]),
            "ec": 2 * int(w["col_embed"]), "rel": 2 * int(w["rel_embed"])}


def trunk_flops(w: dict, emb: int, hid: int, nout: int,
                with_embed_cot: bool):
    """(forward, cotangent) flops per sample of one trunk: every dense
    product of the forward; for the cotangents the output layer, the
    hidden part of every later block's input and the feature injections,
    plus, with with_embed_cot, the embedding's own cotangent and its
    projection back to the point."""
    C, nb, skip = w["C"], w["nb"], w["skip"]
    ins = [emb if i == 0 else (hid + emb if i == skip + 1 else hid)
           for i in range(nb)]
    fwd = 2 * (sum(ins) * hid + nb * C * hid + hid * nout)
    cot = 2 * (hid * nout + (nb - 1) * hid * hid + nb * C * hid)
    if with_embed_cot:
        cot += 2 * (2 * emb * hid + 3 * emb)
    return fwd, cot


def weight_numel(w: dict, emb: int, hid: int, nout: int) -> int:
    C, nb, skip = w["C"], w["nb"], w["skip"]
    ins = [emb if i == 0 else (hid + emb if i == skip + 1 else hid)
           for i in range(nb)]
    return (sum(ins) * hid + nb * hid + nb * (C * hid + hid)
            + hid * nout + nout)


def maploss_work(w: dict, n: int, S: int, u: int, with_color: bool,
                 backward: bool, need_wgrads: bool = True):
    """(bytes, flops) of the union mapping loss on n rays of S samples
    over u union slots (#2 forward; #3, backward, recomputes it): per
    sample the union mix and both trunks; the backward adds the trunks'
    cotangents (the embedding is not differentiated), with colour the
    colour core's weight gradients and the union-mix backward."""
    C = w["C"]
    fg, cg = trunk_flops(w, w["eg"], w["hg"], 1, False)
    fc, cc = (trunk_flops(w, w["ec"], w["hc"], 3, False) if with_color
              else (0, 0))
    mix = 2 * u * C * (2 if with_color else 1)
    per = fg + fc + mix
    wg = with_color and need_wgrads
    if backward:
        per += cg + cc + (fc if wg else 0) + mix
    D = 5 * S + 7 + S * u + u
    fs = 2 * C if with_color else C
    geo_numel = weight_numel(w, w["eg"], w["hg"], 1)
    col_numel = weight_numel(w, w["ec"], w["hc"], 3)
    weights = geo_numel + (col_numel if with_color else 0)
    nbytes = 4 * (n * (D + u * fs + 1 + 12) + weights)
    if backward:
        nbytes += 4 * (n * (u * fs + 12) + (col_numel if wg else 0))
    return nbytes, float(per) * n * S


def trackloss_work(w: dict, n: int, S: int, K: int, backward: bool):
    """(bytes, flops) of a tracking render on n rays of S samples with K
    neighbours each (#8 forward, #9 backward): both trunks with the
    embedding cotangents (the pose is differentiated), the feature mix and
    the distance weights."""
    C = w["C"]
    fg, cg = trunk_flops(w, w["eg"], w["hg"], 1, True)
    fc, cc = trunk_flops(w, w["ec"], w["hc"], 3, True)
    mix = 2 * K * 2 * C + 10 * K
    per = fg + fc + mix
    Dr = 2 * S + 6 + 3 * S * K
    geo_numel = weight_numel(w, w["eg"], w["hg"], 1)
    col_numel = weight_numel(w, w["ec"], w["hc"], 3)
    nbytes = 4 * (n * (6 + Dr + S * K * 2 * C + 12) + geo_numel + col_numel)
    if not backward:
        return nbytes + 4 * n * 5, float(per) * n * S
    per += cg + cc + 2 * K * 2 * C + 12 * K
    return nbytes + 4 * n * 4 + 4 * n * 18, float(per) * n * S


def relpos_flops(w: dict, K: int, backward: bool) -> float:
    """Flops per sample of the rel-pos neighbour MLP on K neighbours
    (Fourier features of the offset, [features | embedding] -> hidden ->
    C); its backward takes the input and weight cotangents."""
    fwd = 2 * K * ((w["C"] + w["rel"]) * w["hc"] + w["hc"] * w["C"])
    return float(fwd * (3 if backward else 1))


def samples_iter_flops(w: dict, n: int, S: int, K: int, with_color: bool,
                       relpos_col: bool) -> float:
    """Flops of one per-sample mapping iteration (forward and backward) on
    n rays of S samples: the geometry trunk with its cotangents, on colour
    stages the colour trunk with cotangents and weight gradients, the
    feature mixes over K neighbours, and the rel-pos neighbour MLP where
    colour encodes it."""
    fg, cg = trunk_flops(w, w["eg"], w["hg"], 1, False)
    per = fg + cg + 2 * 2 * K * w["C"]
    if with_color:
        fc, cc = trunk_flops(w, w["ec"], w["hc"], 3, False)
        per += 2 * fc + cc + 2 * 2 * K * w["C"]
        if relpos_col:
            per += relpos_flops(w, K, True)
    return float(per) * n * S


def topk_work(n: int, C: int, k: int, payload: bool):
    """(bytes, operations) of one row top-k (#1): the (n, C) rows and
    their payload read once, the (n, k) values and picks written once;
    one comparison per entry."""
    nbytes = 4 * n * C * (2 if payload else 1) + 2 * 4 * n * k
    return float(nbytes), float(n * C)


def stage_counts(cfg: dict, n_joint: int, init: bool):
    """(geometry, colour) iterations of a mapped frame over both levels,
    by the mapper's schedule (mid level: geometry through iteration A;
    fine level: geometry through iteration Cb)."""
    m = cfg["mapping"]
    num_mid = int(n_joint * float(m["mid_iter_ratio"]))
    num_fine = int(n_joint * (1 - float(m["mid_iter_ratio"])))
    geo_ratio = float(m["geo_iter_ratio"])
    A = int(m["geo_iter_first"]) if init else int(num_mid * geo_ratio)
    B = num_mid
    Cb = int(num_mid + num_fine * geo_ratio)
    n_geo = n_col = 0
    for j in range(n_joint):
        geo = j <= A if j <= min(B, n_joint - 1) else j <= Cb
        n_geo += geo
        n_col += not geo
    return n_geo, n_col


def _relpos(cfg: dict) -> bool:
    return bool(cfg["model"]["encode_rel_pos_in_col"])


def track_frame_flops(cfg: dict) -> float:
    """A tracked frame's decoder operations: every iteration renders
    tracking.pixels rays through both trunks with the pose's cotangents
    (trackloss_work's count), plus the rel-pos neighbour MLP where colour
    encodes it."""
    w = widths(cfg)
    t = cfg["tracking"]
    n, S = int(t["pixels"]), int(cfg["rendering"]["N_surface"])
    K = int(cfg["pointcloud"]["nn_num"])
    per = trackloss_work(w, n, S, K, True)[1]
    if _relpos(cfg):
        per += 2.0 / 3.0 * relpos_flops(w, K, True) * n * S
    return per * int(t["iters"])


def map_frame_flops(cfg: dict, n_joint: int, init: bool) -> float:
    """A mapped frame's decoder operations over its n_joint iterations:
    the union loss (maploss_work) on the union path, the per-sample
    iteration (samples_iter_flops) otherwise."""
    w = widths(cfg)
    m = cfg["mapping"]
    n, S = int(m["pixels"]), int(cfg["rendering"]["N_surface"])
    K = int(cfg["pointcloud"]["nn_num"])
    n_geo, n_col = stage_counts(cfg, n_joint, init)
    union = not (m["BA"] or _relpos(cfg)
                 or cfg["model"].get("encode_rel_pos_in_geo", False))
    total = 0.0
    for with_color, cnt in ((False, n_geo), (True, n_col)):
        if union:
            f = maploss_work(w, n, S, int(m.get("union_size", 8)),
                             with_color, True,
                             not m["fix_color_decoder"])[1]
        else:
            f = samples_iter_flops(w, n, S, K, with_color, _relpos(cfg))
        total += cnt * f
    return total
