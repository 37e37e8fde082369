"""Whole-iteration mapping loss of the union path (port of
``nicer_fused_maploss``, hpslam_tpu/ops/fused_mlp.py:1365) and its kernels.

Kernels 2 and 3 (``csrc/maploss.cu``): the forward (losses only,
replacing `_maploss_fwd_kernel`) and the combined forward-plus-cotangents
(replacing `_maploss_bwd_kernel`).  Under autograd the combined kernel is
the only launch: ``_MapLoss.forward`` runs it and stashes the cotangents,
``_MapLoss.backward`` scales them by the incoming cotangent, as the
reference's ``_nml_fwd`` / ``_nml_bwd`` do.  Without a gradient the forward
kernel runs.  CPU tensors take ``maploss_plain``: the same arithmetic in
PyTorch ops (after ``_maploss_common``), differentiated by autograd.

The other fused entry points of the reference (fused trunks, fused
composite render, fused tracker loss) are not ported yet and raise.

Packed cache row layout (``mapper.pack_union_cache``), S samples, u union
slots: [z S | pts 3S | rays_d 3 | d_gt 1 | c_gt 3 | pmask S | Wm S*u |
uids u].
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _cuda
from ..models.decoder import fourier_features, softplus100


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


def _trunk(e, c, flat, n_blocks: int, skip: int, act):
    h = e
    for i in range(n_blocks):
        W, b = flat[2 * i], flat[2 * i + 1]
        F, f = flat[2 * n_blocks + 2 * i], flat[2 * n_blocks + 2 * i + 1]
        h = act(h @ W + b)
        h = h + c @ F + f
        if i == skip:
            h = torch.cat([e, h], dim=-1)
    return h @ flat[-2] + flat[-1]


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


# ---------------------------------------------------------------------------
# CUDA path

def _ptr_array(tensors):
    arr = (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() if t is not None else None for t in tensors])
    return arr


def launch_maploss(uf, aff, col_flat, row, okf, geo_flat, Bs, n_blocks,
                   skip, with_color, S, u, C, coef, sigmoid_rgb, use_affine,
                   w_color, backward: bool, need_wgrads: bool, lib=None,
                   stream=None):
    """Run kernel #2 (backward=False) or #3 (backward=True).  Returns
    (gl, cl) or (gl, cl, duf, daff, dcol list)."""
    Bg, Bc = Bs
    n, D = row.shape
    dev = row.device
    hid_g, hid_c = geo_flat[0].shape[1], col_flat[0].shape[1]
    emb_g, emb_c = Bg.shape[1], 2 * Bc.shape[1]
    lib = lib or _cuda.lib("maploss")
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    n_scr = lib.hp_maploss_scratch_floats(n, S, C, emb_g, hid_g, emb_c,
                                          hid_c, n_blocks, int(with_color))
    scratch = torch.empty((n_scr,), dtype=torch.float32, device=dev)
    losses = torch.zeros((2,), dtype=torch.float32, device=dev)
    duf = daff = wpart = None
    dcol = []
    wsplits = 1
    if backward:
        duf = torch.empty_like(uf)
        daff = torch.empty((n, 12), dtype=torch.float32, device=dev)
        if with_color and need_wgrads:
            dcol = [torch.empty_like(w) for w in col_flat]
            wsplits = max(1, -(-(n * S) // 1024))
            wpart = torch.empty((wsplits * (emb_c + hid_c) * hid_c,),
                                dtype=torch.float32, device=dev)
    gw = _ptr_array(geo_flat)
    cw = _ptr_array(col_flat if with_color else geo_flat)
    dcw = _ptr_array(dcol) if dcol else None
    rc = lib.hp_maploss(
        row.data_ptr(), D, uf.data_ptr(), uf.shape[1], okf.data_ptr(),
        aff.data_ptr(), Bg.data_ptr(), Bc.data_ptr(), gw, cw,
        n, S, u, C, emb_g, hid_g, emb_c, hid_c, n_blocks, skip,
        int(with_color), float(coef), int(sigmoid_rgb), int(use_affine),
        float(w_color), int(backward), int(need_wgrads), scratch.data_ptr(),
        losses.data_ptr(), duf.data_ptr() if duf is not None else None,
        daff.data_ptr() if daff is not None else None, dcw,
        wpart.data_ptr() if wpart is not None else None, wsplits, stream)
    _cuda.check(rc, "maploss")
    if not backward:
        return losses[0], losses[1]
    if not (with_color and need_wgrads):
        dcol = [torch.zeros_like(w) for w in col_flat]
    return losses[0], losses[1], duf, daff, dcol


class _MapLoss(torch.autograd.Function):
    """Kernel #3 under autograd: one launch gives the losses and every
    cotangent (for the unit cotangent on geo_loss + w_color * col_loss);
    backward scales them by the geo-loss cotangent, as `_nml_bwd` does."""

    @staticmethod
    def forward(ctx, uf, aff, cfg, row, okf, geo_flat, Bs, *col_flat):
        _cuda.LAUNCHES["maploss_bwd"] += 1
        gl, cl, duf, daff, dcol = launch_maploss(
            uf, aff, col_flat, row, okf, geo_flat, Bs, backward=True, **cfg)
        ctx.save_for_backward(duf, daff, *dcol)
        return gl, cl

    @staticmethod
    def backward(ctx, g_gl, g_cl):
        duf, daff, *dcol = ctx.saved_tensors
        return (duf * g_gl, daff * g_gl, None, None, None, None, None,
                *[d * g_gl for d in dcol])


def _check(name, t, shape=None, dev=None):
    if t.dtype != torch.float32:
        raise ValueError(f"maploss: {name} must be float32")
    if not t.is_contiguous():
        raise ValueError(f"maploss: {name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"maploss: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if dev is not None and t.device != dev:
        raise ValueError(f"maploss: {name} is on {t.device}, not {dev}")


def nicer_fused_maploss(uf, aff, col_core_flat, row, okf, geo_core_flat, Bs,
                        n_blocks: int, skip: int, with_color: bool, S: int,
                        u: int, C: int, coef: float, sigmoid_rgb: bool,
                        use_affine: bool, w_color: float,
                        need_wgrads: bool = True):
    """Mapping loss of one iteration: (geo_loss, col_loss).  The optimised
    total is geo_loss + w_color * col_loss (the kernel's cotangents assume
    it).  Differentiable in ``uf`` (n, u*2C, or u*C without colour), ``aff``
    (n, 12) and, with need_wgrads, the colour-core weights."""
    dev = row.device
    if dev.type == "cpu":
        return maploss_plain(uf, aff, col_core_flat, row, okf, geo_core_flat,
                             Bs, n_blocks, skip, with_color, S, u, C, coef,
                             sigmoid_rgb, use_affine)
    if dev.type != "cuda":
        raise ValueError(f"maploss: unsupported device {dev}")
    n = row.shape[0]
    fstride = 2 * C if with_color else C
    _check("row", row, (n, 5 * S + 7 + S * u + u), dev)
    _check("uf", uf, (n, u * fstride), dev)
    _check("okf", okf, (n, 1), dev)
    _check("aff", aff, (n, 12), dev)
    for name, t in [("Bg", Bs[0]), ("Bc", Bs[1])] \
            + [("geo weight", w) for w in geo_core_flat] \
            + ([("col weight", w) for w in col_core_flat]
               if with_color else []):
        _check(name, t, None, dev)
    if len(geo_core_flat) != 4 * n_blocks + 2 \
            or len(col_core_flat) != 4 * n_blocks + 2:
        raise ValueError("maploss: core weights must follow flatten_core")
    if S > 16 or n_blocks > 8:
        raise ValueError("maploss kernel supports S <= 16, n_blocks <= 8")
    cfg = dict(n_blocks=n_blocks, skip=skip, with_color=with_color, S=S,
               u=u, C=C, coef=coef, sigmoid_rgb=sigmoid_rgb,
               use_affine=use_affine, w_color=w_color,
               need_wgrads=need_wgrads)
    wants_grad = torch.is_grad_enabled() and (
        uf.requires_grad or aff.requires_grad
        or (need_wgrads and any(w.requires_grad for w in col_core_flat)))
    if not wants_grad:
        _cuda.LAUNCHES["maploss_fwd"] += 1
        cfg.pop("need_wgrads")
        return launch_maploss(uf, aff, col_core_flat, row, okf,
                              geo_core_flat, Bs, backward=False,
                              need_wgrads=False, **cfg)
    return _MapLoss.apply(uf, aff, cfg, row, okf, tuple(geo_core_flat),
                          tuple(Bs), *col_core_flat)


def _not_ported(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (hpslam_tpu/ops/fused_mlp.py) is not ported yet; see "
            "ROADMAP.md")
    fn.__name__ = name
    return fn


nicer_fused_color = _not_ported("nicer_fused_color")
nicer_fused_geo = _not_ported("nicer_fused_geo")
nicer_fused_composite = _not_ported("nicer_fused_composite")
nicer_fused_trackloss = _not_ported("nicer_fused_trackloss")
