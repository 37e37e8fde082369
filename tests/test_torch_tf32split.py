"""The 3xTF32 arithmetic of the tensor-core trunk kernels (#2-9,
hpslam_tpu_torch/csrc/nicer_trunk_tc.cuh), emulated in plain PyTorch on
the CPU, against the port's f32 plain trunk and the reference's
_trunk_fwd_block / _trunk_bwd_block (hpslam_tpu/ops/fused_mlp.py) at
exact=True; the tracker-loss backward (#9) as a whole: both trunks
through the emulated products, then the embedding and weight routes of
d(point) and d(rays), held to chip_smoke.check_drays's rule against
trackloss_plain in float64; the composite and tracker-loss forwards
(#6, #8) as a whole, held to the rule that chip_smoke.py's composite and
trackloss phases apply against composite_plain and trackloss_plain; the
mapping-loss forward (#2) as a whole, held to the maploss phase's
LOSS_RTOL against maploss_plain and the reference's Pallas forward; and
the composite backward (#7) as a whole (#6's tile forward, the
compositor backward, #5's tile backward), held to the composite phase's
rule against composite_bwd_plain.

The kernels take every trunk and weight-gradient product on TF32 tensor
cores at f32 accuracy: each f32 operand x is split into hi = tf32(x) and
lo = tf32(x - hi), both rounded to nearest (ties away from zero, as
cvt.rna.tf32.f32 does) on the low 13 mantissa bits, and the product is
lo.hi + hi.lo + hi.hi with f32 accumulation.  The emulation runs that
split through the whole trunk forward and backward at the model's full
widths (embeddings 93 / 40, hidden 32 / 128, 5 blocks, skip 2, feature
32) on 512 samples at room scale.  It must stay within the smoke's
GRAD_REL_FRO (1e-4, relative Frobenius distance) of both f32 references;
a single TF32 pass, shown in the failure message, does not.
"""
import importlib.util
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpslam_tpu.ops import fused_mlp as jFM
from hpslam_tpu_torch.models.decoder import (fourier_features, fourier_proj,
                                             softplus100)
from hpslam_tpu_torch.ops import fused_mlp as tFM

GRAD_REL_FRO = 1e-4
N_SAMPLES = 512


def tf32(x):
    """Round f32 to TF32 (10 explicit mantissa bits), to nearest, ties away
    from zero: the magnitude bits plus half of the dropped range, then the
    low 13 bits cleared."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(x, w):
    """x @ w as the kernels take it: lo.hi + hi.lo + hi.hi."""
    xh, xl = split(x)
    wh, wl = split(w)
    return (xl @ wh + xh @ wl) + xh @ wh


def mm1(x, w):
    """One TF32 pass, for comparison."""
    return tf32(x) @ tf32(w)


def emulated_trunk(e, c, flat, g_out, nb, skip, code, mm):
    """Forward and backward of one trunk with every product through ``mm``,
    in the kernels' order: (out, d_e, d_c, weight grads in flatten_core
    order).  The bias gradients are column sums."""
    act = torch.relu if code == 0 else softplus100
    h, a_s, x_s = e, [], []
    for i in range(nb):
        W, b = flat[2 * i], flat[2 * i + 1]
        F, f = flat[2 * nb + 2 * i], flat[2 * nb + 2 * i + 1]
        x_s.append(h)
        a = mm(h, W) + b
        a_s.append(a)
        h = (act(a) + mm(c, F)) + f
        if i == skip:
            h = torch.cat([e, h], dim=-1)
    out = mm(h, flat[-2]) + flat[-1]
    emb = e.shape[1]
    dh = mm(g_out, flat[-2].T)
    d_e = torch.zeros_like(e)
    d_c = torch.zeros_like(c)
    dW, dF = [None] * (2 * nb), [None] * (2 * nb)
    for i in range(nb - 1, -1, -1):
        if i == skip:
            d_e = d_e + dh[:, :emb]
            dh = dh[:, emb:]
        W, F = flat[2 * i], flat[2 * nb + 2 * i]
        d_c = d_c + mm(dh, F.T)
        dF[2 * i], dF[2 * i + 1] = mm(c.T, dh), torch.sum(dh, 0)
        da = dh * tFM._dact(code, a_s[i])
        dW[2 * i], dW[2 * i + 1] = mm(x_s[i].T, da), torch.sum(da, 0)
        dh = mm(da, W.T)
    d_e = d_e + dh
    return out, d_e, d_c, dW + dF + [mm(h.T, g_out), torch.sum(g_out, 0)]


def _inputs(trunk, seed=11):
    """Embedding (from points at 1-3 m and a Fourier B at the model's
    scale), feature, weights and output cotangent, made with numpy."""
    rng = np.random.default_rng(seed)
    nb, skip, C = 5, 2, 32
    if trunk == "geometry":
        nk, hid, nout, scale, code, cos = 93, 32, 1, 25.0, 0, False
    else:
        nk, hid, nout, scale, code, cos = 20, 128, 3, 32.0, 1, True
    emb = 2 * nk if cos else nk
    d = rng.normal(size=(N_SAMPLES, 3))
    p = d / np.linalg.norm(d, axis=1, keepdims=True) \
        * rng.uniform(1.0, 3.0, (N_SAMPLES, 1))
    B = rng.normal(0.0, scale, (3, nk))
    ins = [emb if i == 0 else (emb + hid if i == skip + 1 else hid)
           for i in range(nb)]
    flat_w = [(rng.normal(size=(k, hid)) / math.sqrt(k),
               rng.normal(0.0, 0.05, hid)) for k in ins]
    flat_f = [(rng.normal(size=(C, hid)) / math.sqrt(C),
               rng.normal(0.0, 0.05, hid)) for _ in range(nb)]
    flat = [w for pair in flat_w + flat_f for w in pair]
    flat += [rng.normal(size=(hid, nout)) / math.sqrt(hid),
             rng.normal(0.0, 0.05, nout)]
    c = rng.normal(0.0, 0.1, (N_SAMPLES, C))
    g = rng.normal(size=(N_SAMPLES, nout))

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))
    e = fourier_features(t(p), t(B), concat_cos=cos)
    return e, t(c), [t(w) for w in flat], t(g), nb, skip, code


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_tf32_split_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 2.0 ** -11 + 2.0 ** -20], dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10, -(1.0 + 2.0 ** -10),
            1.0, 1.0 + 2.0 ** -10]
    assert tf32(x).tolist() == want
    v = torch.tensor(np.random.default_rng(0).normal(size=4096)
                     .astype(np.float32))
    hi, lo = split(v)
    # hi keeps 11 significant bits, lo the next 11: hi + lo is v to 2^-22
    assert float(((hi + lo - v).abs() / v.abs()).max()) <= 2.0 ** -21
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)


@pytest.mark.parametrize("trunk", ["geometry", "colour"])
def test_3xtf32_trunk_matches_f32_references(trunk):
    e, c, flat, g, nb, skip, code = _inputs(trunk)
    act = torch.relu if code == 0 else softplus100
    # the port's f32 plain trunk and its written-out backward
    out0, saved = tFM._trunk_saved(e, c, flat, nb, skip, act)
    de0, dc0, dw0 = tFM._trunk_bwd(g, e, c, flat, saved, nb, skip, code,
                                   True)
    plain = [out0, de0, dc0] + dw0
    # the reference's Pallas block bodies at f32 accuracy
    ws = [jnp.asarray(w.numpy()) for w in flat]
    ej, cj = jnp.asarray(e.numpy()), jnp.asarray(c.numpy())
    outj, savedj = jFM._trunk_fwd_block(ej, cj, ws, nb, skip, code,
                                        save=True, exact=True)
    dej, dcj, dwj = jFM._trunk_bwd_block(jnp.asarray(g.numpy()), ej, cj, ws,
                                         savedj, nb, skip, code, exact=True)
    ref = [outj, dej, dcj] + list(dwj)
    names = ["out", "d_e", "d_c"] + [f"dw{i}" for i in range(len(flat))]
    emu3 = emulated_trunk(e, c, flat, g, nb, skip, code, mm3)
    emu1 = emulated_trunk(e, c, flat, g, nb, skip, code, mm1)
    emu3 = [emu3[0], emu3[1], emu3[2]] + emu3[3]
    emu1 = [emu1[0], emu1[1], emu1[2]] + emu1[3]
    # the two f32 references agree with each other first
    for name, a, b in zip(names, plain, ref):
        assert _rel(a, b) <= GRAD_REL_FRO, (name, _rel(a, b))
    worst3 = max((max(_rel(a, p), _rel(a, r)), name)
                 for name, a, p, r in zip(names, emu3, plain, ref))
    worst1 = max((_rel(a, p), name) for name, a, p in zip(names, emu1, plain))
    msg = (f"{trunk}: 3xTF32 worst {worst3[0]:.3g} ({worst3[1]}); "
           f"single-pass TF32 worst {worst1[0]:.3g} ({worst1[1]})")
    print(msg)
    assert worst3[0] <= GRAD_REL_FRO, msg
    assert worst1[0] > GRAD_REL_FRO, msg


@pytest.mark.parametrize("kernel", ["maploss", "maploss_fwd", "trunks",
                                    "trunks_fwd", "trackloss",
                                    "trackloss_fwd", "composite_fwd",
                                    "composite_bwd"])
def test_tensor_core_kernels_reject_widths_off_the_mma_grid(kernel):
    """Kernels #3, #2, #5, #4, #9, #8, #6 and #7 tile every width by the
    mma's 8: their launchers refuse a hidden width that is not a multiple
    of 8 before building or launching anything."""
    n, C, nb = 4, 8, 2
    geo = [torch.zeros(s) for s in [(16, 12), (12,), (28, 12), (12,)]
           + [(C, 12), (12,)] * nb + [(12, 1), (1,)]]
    col = [torch.zeros(s) for s in [(8, 16), (16,), (24, 16), (16,)]
           + [(C, 16), (16,)] * nb + [(16, 3), (3,)]]
    Bs = (torch.zeros((3, 16)), torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="multiples of 8"):
        if kernel.startswith("maploss"):
            S, u = 2, 2
            bwd = kernel == "maploss"
            row = torch.zeros((n, 5 * S + 7 + S * u + u))
            tFM.launch_maploss(torch.zeros((n, u * 2 * C)),
                               torch.zeros((n, 12)), col, row,
                               torch.ones((n, 1)), geo, Bs, nb, 0, True, S,
                               u, C, 0.1, True, False, 0.1, backward=bwd,
                               need_wgrads=bwd)
        elif kernel == "trunks":
            tFM.launch_trunks(torch.zeros((n, 3)), torch.zeros((n, C)),
                              torch.zeros((n, C)), Bs, geo, col, nb, 0, True,
                              backward=True, g_occ=torch.zeros(n),
                              g_rgb=torch.zeros((n, 3)))
        elif kernel == "trunks_fwd":
            tFM.launch_trunks(torch.zeros((n, 3)), torch.zeros((n, C)),
                              None, (Bs[0], None), geo, [], nb, 0, False,
                              backward=False)
        elif kernel.startswith("composite"):
            S = 2
            bwd = kernel == "composite_bwd"
            tFM.launch_composite(torch.zeros((n * S, 3)),
                                 torch.zeros((n * S, C)),
                                 torch.zeros((n * S, C)), torch.zeros((n, S)),
                                 torch.ones((n, S)), Bs, geo, col, nb, 0,
                                 True, S, 0.1, True, backward=bwd,
                                 dD=torch.zeros(n), dV=torch.zeros(n),
                                 dC=torch.zeros((n, 3)), need_wgrads=True)
        else:
            S, K = 2, 2
            bwd = kernel == "trackloss"
            tFM.launch_trackloss(
                torch.zeros((n, 6)), torch.zeros((n, 12)),
                torch.zeros((n, 2 * S + 6 + 3 * S * K)),
                torch.zeros((n, S * K * 2 * C)), geo, col, Bs, nb, 0, S, K,
                C, 0.1, 0, False, True, backward=bwd,
                g_depth=torch.zeros(n) if bwd else None,
                g_color=torch.zeros((n, 3)) if bwd else None)


# ---------------------------------------------------------------------------
# Kernel #9 as a whole

N_RAYS = 300


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _core(rng, nk, hid, nout, scale, cos, nb, skip, C):
    """One trunk's weights in flatten_core order and its Fourier B, at the
    model's scale, made with numpy."""
    emb = 2 * nk if cos else nk
    ins = [emb if i == 0 else (emb + hid if i == skip + 1 else hid)
           for i in range(nb)]
    flat = []
    for k in ins:
        flat += [rng.normal(size=(k, hid)) / math.sqrt(k),
                 rng.normal(0.0, 0.05, hid)]
    for _ in range(nb):
        flat += [rng.normal(size=(C, hid)) / math.sqrt(C),
                 rng.normal(0.0, 0.05, hid)]
    flat += [rng.normal(size=(hid, nout)) / math.sqrt(hid),
             rng.normal(0.0, 0.05, nout)]
    return flat, rng.normal(0.0, scale, (3, nk))


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _track_inputs(seed=5, n=N_RAYS, S=5, K=8, C=32, nb=5, skip=2, r=0.3):
    """The tracker's operating point as chip_smoke.trackloss_inputs builds
    it (rays toward a wall at ~2 m, K cached neighbours 1e-2 to 1.2 r away,
    one padded slot at 1e6, `has` from those distances), at the model's
    full widths, made with numpy."""
    rng = np.random.default_rng(seed)
    geo, Bg = _core(rng, 93, 32, 1, 25.0, False, nb, skip, C)
    col, Bc = _core(rng, 20, 128, 3, 32.0, True, nb, skip, C)
    ro = 0.05 * rng.normal(size=(n, 3))
    rd = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), -np.ones((n, 1))],
                        1)
    z = rng.uniform(1.8, 2.2, (n, 1)) * np.linspace(0.96, 1.04, S)
    pts = ro[:, None] + z[..., None] * rd[:, None]
    u = rng.normal(size=(n, S, K, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    cpos = pts[:, :, None] + u * rng.uniform(1e-2, 1.2 * r, (n, S, K, 1))
    cpos[:, :, -1] = 1e6
    has = (np.sum(np.sum((cpos - pts[:, :, None]) ** 2, -1) < r * r, -1)
           >= 2).astype(np.float64)
    rowc = np.concatenate([z, z[:, S // 2:S // 2 + 1], rng.uniform(size=(
        n, 3)), np.full((n, 1), r * r), has, np.ones((n, 1)),
        cpos.reshape(n, -1)], 1)
    aff = np.concatenate([np.tile(np.eye(3).reshape(1, 9), (n, 1)),
                          np.zeros((n, 3))], 1) \
        + 0.05 * rng.normal(size=(n, 12))
    return dict(rays=_t(np.concatenate([ro, rd], 1)), aff=_t(aff),
                rowc=_t(rowc),
                cfeat=_t(0.1 * rng.normal(size=(n, S * K * 2 * C))),
                g_depth=_t(rng.normal(size=n)), g_color=_t(rng.normal(
                    size=(n, 3))), geo=[_t(w) for w in geo],
                col=[_t(w) for w in col], Bs=(_t(Bg), _t(Bc)),
                static=(nb, skip, S, K, C))


def _tail(occ, raw, aff, has, z, coef, use_affine, sigmoid_plain):
    """trackloss_plain's colour tail and compositor on (n, S) occ and
    (n, S, 3) raw: (depth, color, var)."""
    if use_affine:
        a = aff[:, None, :]
        rgb = torch.sigmoid(torch.stack([
            raw[..., 0] * a[..., d] + raw[..., 1] * a[..., 3 + d]
            + raw[..., 2] * a[..., 6 + d] + a[..., 9 + d]
            for d in range(3)], -1))
    else:
        rgb = torch.sigmoid(raw) if sigmoid_plain else raw
    alpha = torch.sigmoid(coef * torch.where(has, occ, -100.0))
    ts, t_run = [], torch.ones_like(alpha[:, 0])
    for s in range(z.shape[1]):
        ts.append(t_run)
        t_run = t_run * ((1.0 - alpha[:, s]) + 1e-10)
    wc = alpha * torch.stack(ts, 1)
    wsum = torch.sum(wc, 1) + 1e-10
    depth = torch.sum(wc * z, 1) / wsum
    return (depth, torch.sum(wc[..., None] * rgb, 1) / wsum[:, None],
            torch.sum(wc * torch.square(z - depth[:, None]), 1))


def _track_samples(I, static):
    """What both tracker-loss kernels compute for the samples before the
    trunks: the points, their neighbours' distances and weights inside
    r^2, the mixed features (zero unless `has`), the Fourier embeddings,
    and per trunk (embedding, feature, weights, activation code, outputs)."""
    nb, skip, S, K, C = static[:5]
    wmode = static[6]
    rays, rowc, Bg, Bc = I["rays"], I["rowc"], I["Bs"][0], I["Bs"][1]
    n = rays.shape[0]
    o = tFM.trackrow_offsets(S, K)
    z = rowc[:, :S]
    r2 = rowc[:, o["r2"]:o["r2"] + 1]
    has = rowc[:, o["has"]:o["has"] + S] > 0.5
    cpos = rowc[:, o["cpos"]:o["cpos"] + 3 * S * K].reshape(n, S, K, 3)
    pts = rays[:, None, :3] + z[..., None] * rays[:, None, 3:]
    dd = torch.sum(torch.square(cpos - pts[:, :, None]), -1)
    inr = dd <= r2[..., None]
    if wmode == 0:
        w = torch.where(inr, 1.0 / (dd + 1e-10), 0.0)
    else:
        w = torch.where(inr, torch.exp(-20.0 * torch.sqrt(
            torch.clamp(dd, min=1e-12))), 0.0)
    wsafe = torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-12)
    f = I["cfeat"].reshape(n, S, K, 2 * C)
    c = torch.where(has[..., None], torch.sum((w / wsafe)[..., None] * f, 2),
                    0.0).reshape(n * S, 2 * C)
    p = pts.reshape(n * S, 3)
    eg = fourier_features(p, Bg, concat_cos=False)
    ec = fourier_features(p, Bc, concat_cos=True)
    return dict(n=n, z=z, has=has, cpos=cpos, pts=pts, dd=dd, inr=inr, w=w,
                wsafe=wsafe, f=f, p=p,
                trunks=((eg, c[:, :C], I["geo"], 0, 1),
                        (ec, c[:, C:], I["col"], 1, 3)))


def _trunk_outputs(trunks, nb, skip, mm):
    """Each trunk's output with its products through ``mm``."""
    return [emulated_trunk(e, cc, flat, torch.zeros((e.shape[0], nout)), nb,
                           skip, code, mm)[0]
            for e, cc, flat, code, nout in trunks]


def emulated_trackloss_drays(I, static, mm):
    """d rays of kernel #9 with both trunks' products through ``mm``: the
    forward recomputed, the compositor and tail backward (scalar f32 in the
    kernel), both trunk backwards with the embedding cotangents, then
    d(point) = embedding route + weight route (the quotient rule through
    w / max(sum w, 1e-12), masked by `has` and d^2 <= r^2), then d(o) and
    d(d) summed over the samples."""
    nb, skip, S, K, C, coef, wmode, use_affine, sigmoid_plain = static
    T = _track_samples(I, static)
    n, z, has, cpos, pts, dd, inr, w, wsafe, f, p, trunks = (
        T[k] for k in ("n", "z", "has", "cpos", "pts", "dd", "inr", "w",
                       "wsafe", "f", "p", "trunks"))
    Bg, Bc = I["Bs"]
    outs = _trunk_outputs(trunks, nb, skip, mm)
    occ = outs[0][:, 0].detach().requires_grad_()
    raw = outs[1].detach().requires_grad_()
    depth, color, _ = _tail(occ.reshape(n, S), raw.reshape(n, S, 3),
                            I["aff"], has, z, coef, use_affine,
                            sigmoid_plain)
    g_occ, g_raw = torch.autograd.grad([depth, color], [occ, raw],
                                       [I["g_depth"], I["g_color"]])
    (_, d_eg, d_cg, _), (_, d_ec, d_cc, _) = [
        emulated_trunk(e, cc, flat, g, nb, skip, code, mm)
        for (e, cc, flat, code, _), g in zip(trunks, (g_occ[:, None],
                                                      g_raw))]
    # embedding route
    tp = 2.0 * math.pi
    proj_c = fourier_proj(p, Bc)
    m = proj_c.shape[-1]
    dp = tp * ((torch.cos(fourier_proj(p, Bg)) * d_eg) @ Bg.T) \
        + tp * ((torch.cos(proj_c) * d_ec[:, :m]
                 - torch.sin(proj_c) * d_ec[:, m:]) @ Bc.T)
    # weight route: d wn_j = <dc_g, feat_g_j> + <dc_c, feat_c_j>
    dwn = torch.sum(d_cg.reshape(n, S, 1, C) * f[..., :C], -1) \
        + torch.sum(d_cc.reshape(n, S, 1, C) * f[..., C:], -1)
    inner = torch.sum(dwn * w, -1, keepdim=True) / (wsafe * wsafe)
    dwj = dwn / wsafe - inner
    if wmode == 0:
        ddd = -dwj * w * w
    else:
        ddd = dwj * w * (-10.0 / torch.sqrt(torch.clamp(dd, min=1e-12)))
    ddd = torch.where(inr & has[..., None], ddd, 0.0)
    dp = dp.reshape(n, S, 3) + torch.sum(
        ddd[..., None] * 2.0 * (pts[:, :, None] - cpos), 2)
    return torch.cat([torch.sum(dp, 1), torch.sum(z[..., None] * dp, 1)], 1)


@pytest.mark.parametrize("use_affine,wmode", [(False, 0), (True, 0),
                                              (False, 1)])
def test_3xtf32_trackloss_drays_meets_check_drays(use_affine, wmode):
    """Kernel #9's arithmetic with 3xTF32 products, at the full model width
    on 300 rays, against trackloss_plain (f32, autograd) and float64, by
    chip_smoke.check_drays's rule: within twice the f32 plain version's
    distance from float64, in norm and entry by entry.  One TF32 pass per
    product misses it."""
    cs = _chip_smoke()
    I = _track_inputs()
    static = I["static"] + (0.1, wmode, use_affine, not use_affine)
    k = emulated_trackloss_drays(I, static, mm3)
    r = I["rays"].clone().requires_grad_()
    d, _v, c = tFM.trackloss_plain(r, I["aff"], I["rowc"], I["cfeat"],
                                   I["geo"], I["col"], I["Bs"], *static)
    torch.autograd.backward([d, c], [I["g_depth"], I["g_color"]])
    readings = cs.check_drays(I, static, k, r.grad)
    print("drays readings", use_affine, wmode, readings)
    # a single TF32 pass does not meet the rule
    with pytest.raises(AssertionError, match="trackloss drays"):
        cs.check_drays(I, static, emulated_trackloss_drays(I, static, mm1),
                       r.grad)


# ---------------------------------------------------------------------------
# Kernels #6 and #8 as a whole


def _comp_inputs(seed=7, n=N_RAYS, S=5, C=32, nb=5, skip=2):
    """The mesh mapping path's samples as chip_smoke.composite_inputs
    builds them (rays from the origin, samples 1-3 m along them, a tenth
    padded), at the model's full widths, made with numpy."""
    rng = np.random.default_rng(seed)
    geo, Bg = _core(rng, 93, 32, 1, 25.0, False, nb, skip, C)
    col, Bc = _core(rng, 20, 128, 3, 32.0, True, nb, skip, C)
    rd = rng.normal(size=(n, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    z = rng.uniform(1.0, 3.0, (n, 1)) * np.linspace(0.96, 1.04, S)
    return dict(p=_t((rd[:, None] * z[..., None]).reshape(n * S, 3)),
                z=_t(z), pm=_t(rng.uniform(size=(n, S)) > 0.1),
                cg=_t(0.1 * rng.normal(size=(n * S, C))),
                cc=_t(0.1 * rng.normal(size=(n * S, C))),
                geo=[_t(w) for w in geo], col=[_t(w) for w in col],
                Bs=(_t(Bg), _t(Bc)), nb=nb, skip=skip, S=S)


def emulated_composite(I, with_color, sigmoid_rgb, mm):
    """Kernel #6's (depth, var, color) with both trunks' products through
    ``mm`` (the tile pass), then the compositor (cp_rays, scalar f32)."""
    nb, skip, S = I["nb"], I["skip"], I["S"]
    p, (Bg, Bc) = I["p"], I["Bs"]
    trunks = [(fourier_features(p, Bg, concat_cos=False), I["cg"], I["geo"],
               0, 1)]
    if with_color:
        trunks.append((fourier_features(p, Bc, concat_cos=True), I["cc"],
                       I["col"], 1, 3))
    outs = _trunk_outputs(trunks, nb, skip, mm)
    rgb = torch.zeros((p.shape[0], 3))
    if with_color:
        rgb = torch.sigmoid(outs[1]) if sigmoid_rgb else outs[1]
    n = I["z"].shape[0]
    d, v, c, _ = tFM.comp_fwd(outs[0][:, 0].reshape(n, S),
                              rgb.reshape(n, S, 3), I["z"], I["pm"] > 0.5,
                              0.1)
    return d, v, c


def emulated_trackloss(I, static, mm):
    """Kernel #8's (depth, var, color) with both trunks' products through
    ``mm`` (the tile pass), then the colour tail and compositor (tl_rays,
    scalar f32)."""
    nb, skip, S, K, C, coef, wmode, use_affine, sigmoid_plain = static
    T = _track_samples(I, static)
    occ, raw = _trunk_outputs(T["trunks"], nb, skip, mm)
    n = T["n"]
    d, c, v = _tail(occ.reshape(n, S), raw.reshape(n, S, 3), I["aff"],
                    T["has"], T["z"], coef, use_affine, sigmoid_plain)
    return d, v, c


def _map_inputs(seed=9, n=N_RAYS, S=5, u=8, C=32, nb=5, skip=2):
    """The mapping loss's operating point as chip_smoke.maploss_inputs
    builds it (rays at 2-2.5 m, samples around them, a tenth padded, u
    union slots with normalised weights, a twentieth of the rays not ok,
    near-identity exposure affines), at the model's full widths, made with
    numpy.  uf holds both trunks' features (u * 2C); the geometry-only
    stage takes the first C of each slot."""
    rng = np.random.default_rng(seed)
    geo, Bg = _core(rng, 93, 32, 1, 25.0, False, nb, skip, C)
    col, Bc = _core(rng, 20, 128, 3, 32.0, True, nb, skip, C)
    z = rng.uniform(2.0, 2.5, (n, 1)) * np.linspace(0.96, 1.04, S)
    rd = rng.normal(size=(n, 3))
    pts = rd[:, None] * z[..., None] + 0.01 * rng.normal(size=(n, S, 3))
    d_gt = z[:, S // 2:S // 2 + 1] * (1 + 0.02 * rng.normal(size=(n, 1)))
    pm = rng.uniform(size=(n, S)) > 0.1
    Wm = rng.uniform(size=(n, S, u))
    Wm = (Wm / Wm.sum(-1, keepdims=True)).reshape(n, S * u)
    row = np.concatenate([z, pts.reshape(n, 3 * S), rd, d_gt,
                          rng.uniform(size=(n, 3)), pm, Wm,
                          np.zeros((n, u))], 1)
    aff = np.concatenate([np.tile(np.eye(3).reshape(1, 9), (n, 1))
                          + 0.05 * rng.normal(size=(n, 9)),
                          0.05 * rng.normal(size=(n, 3))], 1)
    return dict(row=_t(row), uf=_t(0.1 * rng.normal(size=(n, u * 2 * C))),
                okf=_t(rng.uniform(size=(n, 1)) > 0.05), aff=_t(aff),
                geo=[_t(w) for w in geo], col=[_t(w) for w in col],
                Bs=(_t(Bg), _t(Bc)), static=(nb, skip, S, u, C))


def _map_uf(I, with_color):
    """uf of the stage: both trunks' features, or the geometry's alone."""
    u, C = I["static"][3:]
    uf = I["uf"]
    return uf if with_color else \
        uf.reshape(uf.shape[0], u, 2 * C)[..., :C].reshape(uf.shape[0], -1)


def emulated_maploss(I, with_color, sigmoid_rgb, use_affine, mm):
    """Kernel #2's (geo_loss, col_loss) with both trunks' products through
    ``mm``: the union mix and the embeds, the tile forward (ml_fwd_tiles),
    then the compositor, the affine and the masked L1 per ray (ml_rays,
    scalar f32) and their sums (loss_reduce)."""
    nb, skip, S, u, C = I["static"]
    row, (Bg, Bc) = I["row"], I["Bs"]
    n = row.shape[0]
    o = tFM.row_offsets(S, u)
    p = row[:, o["pts"]:o["pts"] + 3 * S].reshape(n * S, 3)
    pm = row[:, o["pm"]:o["pm"] + S] > 0.5
    Wm = row[:, o["wm"]:o["wm"] + S * u].reshape(n, S, u)
    ufr = _map_uf(I, with_color).reshape(n, u, -1)

    def mix(c0):
        return torch.where(pm[..., None], torch.einsum(
            "nsu,nuc->nsc", Wm, ufr[..., c0:c0 + C]), 0.0).reshape(n * S, C)
    trunks = [(fourier_features(p, Bg, concat_cos=False), mix(0), I["geo"],
               0, 1)]
    if with_color:
        trunks.append((fourier_features(p, Bc, concat_cos=True), mix(C),
                       I["col"], 1, 3))
    outs = _trunk_outputs(trunks, nb, skip, mm)
    rgb = torch.zeros((n, S, 3))
    if with_color:
        rgb = outs[1].reshape(n, S, 3)
        rgb = torch.sigmoid(rgb) if sigmoid_rgb else rgb
    alpha = torch.sigmoid(0.1 * torch.where(pm, outs[0][:, 0].reshape(n, S),
                                            -100.0))
    ts, t_run = [], torch.ones(n)
    for s_ in range(S):
        ts.append(t_run)
        t_run = t_run * ((1.0 - alpha[:, s_]) + 1e-10)
    w = alpha * torch.stack(ts, 1)
    wsum = torch.sum(w, 1) + 1e-10
    depth = torch.sum(w * row[:, :S], 1) / wsum
    color = torch.sum(w[..., None] * rgb, 1) / wsum[:, None]
    if use_affine and with_color:
        a = I["aff"]
        color = torch.sigmoid(torch.stack([
            color[:, 0] * a[:, d] + color[:, 1] * a[:, 3 + d]
            + color[:, 2] * a[:, 6 + d] + a[:, 9 + d] for d in range(3)], 1))
    mask = (I["okf"][:, 0] > 0.5) & (torch.sum(pm, 1) >= S // 2 + 1) \
        & torch.isfinite(depth)
    gl = torch.sum(torch.where(mask, torch.abs(row[:, o["d_gt"]] - depth),
                               0.0))
    cl = torch.sum(torch.where(mask[:, None], torch.abs(
        row[:, o["c_gt"]:o["c_gt"] + 3] - color), 0.0)) if with_color \
        else torch.zeros(())
    return gl, cl


def _maploss_fwd_readings(cs, case):
    """Kernel #2's emulated losses against maploss_plain and the
    reference's nicer_fused_maploss forward (its Pallas kernel #2 in
    interpret mode), each within the smoke's LOSS_RTOL; the two f32
    references agree with each other first."""
    I = _map_inputs()
    with_color = case != "geometry only"
    use_affine = case == "colour, affine"
    nb, skip, S, u, C = I["static"]
    uf = _map_uf(I, with_color)
    args = (nb, skip, with_color, S, u, C, 0.1, not use_affine, use_affine)
    k = emulated_maploss(I, with_color, not use_affine, use_affine, mm3)
    p = tFM.maploss_plain(uf, I["aff"], I["col"], I["row"], I["okf"],
                          I["geo"], I["Bs"], *args)

    def j(x):
        return jnp.asarray(x.numpy())
    r = jFM.nicer_fused_maploss(
        j(uf), j(I["aff"]), tuple(j(w) for w in I["col"]), j(I["row"]),
        j(I["okf"]), tuple(j(w) for w in I["geo"]),
        (j(I["Bs"][0]), j(I["Bs"][1])), *args, 0.1)
    readings = {}
    for name, a, b, c in zip(("gl", "cl"), k, p, r):
        a, b, c = float(a), float(b), float(c)
        if name == "cl" and not with_color:
            assert a == b == c == 0.0
            continue
        rel_ref = abs(b - c) / abs(c)
        rel = max(abs(a - b) / abs(b), abs(a - c) / abs(c))
        readings[name] = (rel, rel_ref)
        assert rel_ref <= cs.LOSS_RTOL, (name, rel_ref)
        assert rel <= cs.LOSS_RTOL, (name, rel)
    return readings


@pytest.mark.parametrize("kernel,case", [
    ("composite_fwd", "colour, sigmoid"), ("composite_fwd", "colour, raw"),
    ("composite_fwd", "geometry only"), ("trackloss_fwd", "sigmoid"),
    ("trackloss_fwd", "affine"), ("trackloss_fwd", "exp weights"),
    ("maploss_fwd", "colour, sigmoid"), ("maploss_fwd", "colour, affine"),
    ("maploss_fwd", "geometry only")])
def test_3xtf32_forward_meets_smoke_tolerances(kernel, case):
    """Kernels #6, #8 and #2 with 3xTF32 trunk products, at the full model
    width on 300 rays x 5 samples.  #6 and #8: depth, var and colour
    against the f32 plain version (composite_plain, trackloss_plain) by
    the rule the smoke's composite and trackloss phases apply
    (chip_smoke.compare_grads: relative Frobenius distance 1e-4, and 1e-3
    of the largest magnitude entry by entry for all but 1e-4 of the
    entries).  #2: both losses within the maploss phase's LOSS_RTOL of
    maploss_plain and of the reference's Pallas forward."""
    cs = _chip_smoke()
    if kernel == "maploss_fwd":
        print(kernel, case, _maploss_fwd_readings(cs, case))
        return
    if kernel == "composite_fwd":
        I = _comp_inputs()
        with_color = case != "geometry only"
        sigmoid_rgb = case == "colour, sigmoid"
        k = emulated_composite(I, with_color, sigmoid_rgb, mm3)
        p = tFM.composite_plain(
            I["p"], I["cg"], I["cc"] if with_color else None, I["z"],
            I["pm"], I["Bs"], I["geo"], I["col"] if with_color else [],
            I["nb"], I["skip"], with_color, I["S"], 0.1, sigmoid_rgb)[:3]
    else:
        I = _track_inputs()
        use_affine = case == "affine"
        static = I["static"] + (0.1, int(case == "exp weights"), use_affine,
                                not use_affine)
        k = emulated_trackloss(I, static, mm3)
        p = tFM.trackloss_plain(I["rays"], I["aff"], I["rowc"], I["cfeat"],
                                I["geo"], I["col"], I["Bs"], *static)
        with_color = True
    readings = {}
    for name, a, b in zip(("depth", "var", "color"), k, p):
        if name == "color" and not with_color:
            assert not a.any()
            continue
        readings[name] = cs.compare_grads(name, a, b, kernel)
    print(kernel, case, readings)


# ---------------------------------------------------------------------------
# Kernel #7 as a whole


def emulated_composite_bwd(I, with_color, sigmoid_rgb, dD, dV, dC, mm):
    """Kernel #7's (dc_geo, dc_col, colour-core weight grads) with both
    trunks' products through ``mm``: #6's tile forward (cp_fwd_tiles) ->
    occ, rgb; the compositor backward and the sigmoid chain (cp_rays,
    scalar f32) -> the per-sample cotangents; then #5's tile backward
    (cp_bwd_tiles: the forward recomputed, both trunk backwards) and the
    colour core's weight gradients, no position cotangent."""
    nb, skip, S = I["nb"], I["skip"], I["S"]
    p, (Bg, Bc) = I["p"], I["Bs"]
    trunks = [(fourier_features(p, Bg, concat_cos=False), I["cg"], I["geo"],
               0, 1)]
    if with_color:
        trunks.append((fourier_features(p, Bc, concat_cos=True), I["cc"],
                       I["col"], 1, 3))
    outs = _trunk_outputs(trunks, nb, skip, mm)
    rgb = torch.zeros((p.shape[0], 3))
    if with_color:
        rgb = torch.sigmoid(outs[1]) if sigmoid_rgb else outs[1]
    g_occ, g_rgb = tFM.comp_cotangents(outs[0][:, 0], rgb, I["z"], I["pm"],
                                       0.1, dD, dV, dC,
                                       sigmoid_rgb and with_color)
    grads = [emulated_trunk(e, cc, flat, g, nb, skip, code, mm)
             for (e, cc, flat, code, _), g in zip(trunks, (g_occ[:, None],
                                                           g_rgb))]
    dcc = grads[1][2] if with_color else torch.zeros_like(I["cg"])
    dcol = grads[1][3] if with_color else []
    return grads[0][2], dcc, dcol


@pytest.mark.parametrize("case", ["colour, sigmoid", "colour, raw",
                                  "geometry only"])
def test_3xtf32_composite_bwd_meets_smoke_tolerances(case):
    """Kernel #7 with 3xTF32 trunk products, at the full model width on 300
    rays x 5 samples: d c_geo, d c_col and the colour core's weight
    gradients against the f32 plain version (composite_bwd_plain, the
    composition the reference's VJP runs) by the rule the smoke's
    composite phase applies (chip_smoke.compare_grads)."""
    cs = _chip_smoke()
    I = _comp_inputs()
    with_color = case != "geometry only"
    sigmoid_rgb = case == "colour, sigmoid"
    rng = np.random.default_rng(13)
    n = I["z"].shape[0]
    dD, dV = _t(rng.normal(size=n)), _t(rng.normal(size=n))
    dC = _t(rng.normal(size=(n, 3)))
    k = emulated_composite_bwd(I, with_color, sigmoid_rgb, dD, dV, dC, mm3)
    p = tFM.composite_bwd_plain(
        I["p"], I["cg"], I["cc"] if with_color else None, I["z"], I["pm"],
        I["Bs"], I["geo"], I["col"] if with_color else [], dD, dV, dC,
        I["nb"], I["skip"], with_color, I["S"], 0.1, True, sigmoid_rgb)
    pairs = [("dcg", k[0], p[0])]
    if with_color:
        pairs += [("dcc", k[1], p[1])]
        pairs += [(f"dcol{i}", a, b) for i, (a, b) in enumerate(zip(k[2],
                                                                   p[2]))]
    else:
        assert not p[1].any()
    readings = {name: cs.compare_grads(name, a, b, "composite")
                for name, a, b in pairs}
    print("composite_bwd", case, readings)
