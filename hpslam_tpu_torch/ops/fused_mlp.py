"""The reference's fused decoder entry points (hpslam_tpu/ops/fused_mlp.py)
and their hand-written kernels.  Every kernel has a plain PyTorch version
beside it; a wrapper takes the plain version only for CPU tensors and, for
CUDA tensors, launches its kernel or raises.

* ``nicer_fused_maploss`` (reference :1365): the union path's
  whole-iteration mapping loss, kernels #2 and #3 (``csrc/maploss.cu``):
  the forward (losses only, replacing `_maploss_fwd_kernel`) and the
  combined forward-plus-cotangents (replacing `_maploss_bwd_kernel`), whose
  trunk passes and weight gradients run on the tensor cores at f32
  accuracy (``csrc/nicer_trunk_tc.cuh``).
  Under autograd the combined kernel is the only launch:
  ``_MapLoss.forward`` runs it and stashes the cotangents,
  ``_MapLoss.backward`` scales them by the incoming cotangent, as the
  reference's ``_nml_fwd`` / ``_nml_bwd`` do.  Without a gradient the
  forward kernel runs.  Plain version: ``maploss_plain``, differentiated by
  autograd.
* ``nicer_fused_color`` / ``nicer_fused_geo`` (reference :611, :653): the
  two decoder trunks, kernels #4 and #5 (``csrc/trunks.cu``), forward and
  remat backward, both on the tensor cores as #3's.  Plain versions:
  ``fused_trunks_plain`` and ``fused_trunks_plain_bwd``.
* ``nicer_fused_trackloss`` (reference :1829): the tracker's
  pose-differentiable render, kernels #8 and #9 (``csrc/trackloss.cu``);
  both run their trunks on the tensor cores, #9's forward recompute the
  same tile pass as #8.  Plain version: ``trackloss_plain``,
  differentiated by autograd.
* ``nicer_fused_composite`` (reference :825): both trunks and the
  occupancy compositor per ray, kernel #6 (``csrc/composite.cu``) forward,
  its trunks on the tensor cores in #4's tile pass;
  its backward is the reference's ``_ncomp_bwd``: the compositor backward
  written out (``comp_bwd``) on the saved occ / rgb, then the trunk
  backward (kernel #5).  The union mapping path runs it under a device
  mesh.  Plain version: ``composite_plain``.  Kernel #7, the fully fused
  backward (``fused_comp_bwd``, reference ``_fused_comp_bwd`` :756: #6's
  tile pass, the compositor backward, #5's tile backward), is held against
  that composition (``composite_bwd_plain``) and, as in the reference,
  called by no path.

Packed cache row layout of the mapping loss (``mapper.pack_union_cache``),
S samples, u union slots: [z S | pts 3S | rays_d 3 | d_gt 1 | c_gt 3 |
pmask S | Wm S*u | uids u].
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _cuda
from ..models.decoder import fourier_features, fourier_proj, softplus100


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


def _dact(code: int, a):
    """activation'(a) from the pre-activation (ReLU 0, Softplus(100) 1)."""
    if code == 0:
        return (a > 0.0).to(a.dtype)
    bx = 100.0 * a
    return torch.where(bx > 20.0, torch.ones_like(a),
                       torch.sigmoid(torch.clamp(bx, max=20.0)))


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
        a = h @ W + b
        a_s.append(a)
        h = act(a) + c @ F + f
        if i == skip:
            h = torch.cat([e, h], dim=-1)
    return h @ flat[-2] + flat[-1], (a_s, x_s, h)


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


# ---------------------------------------------------------------------------
# CUDA path

def _ptr_array(tensors):
    arr = (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() if t is not None else None for t in tensors])
    return arr


def _wgrad_partials(col_flat, M: int, dev):
    """(ranges, scratch) of the tensor-core weight gradients of kernels #3,
    #5 and #7: ceil(M / 1024) fixed sample ranges, each with a partial of
    every weight and bias of the colour core."""
    wsplits = max(1, -(-M // 1024))
    numel = sum(w.numel() for w in col_flat)
    return wsplits, torch.empty((wsplits * numel,), dtype=torch.float32,
                                device=dev)


def _check_tc_widths(what, *widths):
    if any(w % 8 for w in widths):
        raise ValueError(f"{what}: the tensor-core kernel needs hidden and "
                         f"feature widths that are multiples of 8, got "
                         f"{widths}")


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
    if backward:
        _check_tc_widths("maploss", hid_g, hid_c, C)
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
            wsplits, wpart = _wgrad_partials(col_flat, n * S, dev)
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


def _check(name, t, shape=None, dev=None, what="maploss"):
    if t.dtype != torch.float32:
        raise ValueError(f"{what}: {name} must be float32")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if dev is not None and t.device != dev:
        raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")


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


def _weights_of(flat):
    return [w.contiguous() for w in flat]


# ---------------------------------------------------------------------------
# Fused trunks: nicer_fused_color / nicer_fused_geo (kernels #4 and #5,
# csrc/trunks.cu).  Under autograd the forward launches kernel #4 and the
# backward kernel #5, which recomputes the forward, as the reference's
# custom VJP does.  CPU tensors take fused_trunks_plain and
# fused_trunks_plain_bwd, the backward written out as the reference's
# _trunk_bwd_block writes it.

def _trunk_bwd(g_out, e, c, flat, saved, n_blocks: int, skip: int,
               code: int, need_wgrads: bool):
    """Backward of one trunk (the reference's _trunk_bwd_block): (d_e, d_c,
    weight grads in flatten_core order, or None)."""
    a_s, x_s, h_last = saved
    dh = g_out @ flat[-2].T
    d_e = torch.zeros_like(e)
    d_c = torch.zeros_like(c)
    dW, dF = [None] * (2 * n_blocks), [None] * (2 * n_blocks)
    for i in range(n_blocks - 1, -1, -1):
        if i == skip:
            d_e = d_e + dh[:, :e.shape[1]]
            dh = dh[:, e.shape[1]:]
        W, F = flat[2 * i], flat[2 * n_blocks + 2 * i]
        d_c = d_c + dh @ F.T
        da = dh * _dact(code, a_s[i])
        if need_wgrads:
            dF[2 * i], dF[2 * i + 1] = c.T @ dh, torch.sum(dh, 0)
            dW[2 * i], dW[2 * i + 1] = x_s[i].T @ da, torch.sum(da, 0)
        dh = da @ W.T
    d_e = d_e + dh
    if not need_wgrads:
        return d_e, d_c, None
    return d_e, d_c, dW + dF + [h_last.T @ g_out, torch.sum(g_out, 0)]


def fused_trunks_plain(p, c_geo, c_col, Bs, geo_flat, col_flat,
                       n_blocks: int, skip: int, with_color: bool):
    """Plain version of kernel #4: (occ (n,), raw rgb (n, 3), zero without
    colour)."""
    Bg, Bc = Bs
    occ = _trunk(fourier_features(p, Bg, concat_cos=False), c_geo,
                 geo_flat, n_blocks, skip, torch.relu)[:, 0]
    if not with_color:
        return occ, torch.zeros((p.shape[0], 3), dtype=p.dtype,
                                device=p.device)
    rgb = _trunk(fourier_features(p, Bc, concat_cos=True), c_col, col_flat,
                 n_blocks, skip, softplus100)
    return occ, rgb


def fused_trunks_plain_bwd(p, c_geo, c_col, Bs, geo_flat, col_flat, g_occ,
                           g_rgb, n_blocks: int, skip: int, with_color: bool,
                           need_dp: bool, need_wgrads: bool):
    """Plain version of kernel #5: (dp (n, 3), dc_geo, dc_col, colour-core
    weight grads or None), written out as the reference's _bwd_kernel."""
    Bg, Bc = Bs
    tp = 2.0 * math.pi
    eg = fourier_features(p, Bg, concat_cos=False)
    _, saved = _trunk_saved(eg, c_geo, geo_flat, n_blocks, skip, torch.relu)
    d_eg, dcg, _ = _trunk_bwd(g_occ.reshape(-1, 1), eg, c_geo, geo_flat,
                              saved, n_blocks, skip, 0, False)
    dp = torch.zeros_like(p)
    if need_dp:
        dp = tp * ((torch.cos(fourier_proj(p, Bg)) * d_eg) @ Bg.T)
    if not with_color:
        return dp, dcg, torch.zeros_like(c_geo), None
    ec = fourier_features(p, Bc, concat_cos=True)
    _, saved = _trunk_saved(ec, c_col, col_flat, n_blocks, skip, softplus100)
    d_ec, dcc, dcol = _trunk_bwd(g_rgb, ec, c_col, col_flat, saved,
                                 n_blocks, skip, 1, need_wgrads)
    if need_dp:
        proj = fourier_proj(p, Bc)
        m = proj.shape[-1]
        dproj = torch.cos(proj) * d_ec[:, :m] - torch.sin(proj) * d_ec[:, m:]
        dp = dp + tp * (dproj @ Bc.T)
    return dp, dcg, dcc, dcol


def launch_trunks(p, c_geo, c_col, Bs, geo_flat, col_flat, n_blocks, skip,
                  with_color, backward: bool, g_occ=None, g_rgb=None,
                  need_dp: bool = False, need_wgrads: bool = False):
    """Run kernel #4 (backward=False): (occ, rgb); or #5: (dp, dcg, dcc,
    colour-core weight grads or None)."""
    Bg, Bc = Bs
    n, C = c_geo.shape
    dev = p.device
    hid_g, emb_g = geo_flat[0].shape[1], Bg.shape[1]
    hid_c = col_flat[0].shape[1] if with_color else hid_g
    emb_c = 2 * Bc.shape[1] if with_color else emb_g
    need_dp = bool(backward and need_dp)
    wgrads = bool(backward and with_color and need_wgrads)
    _check_tc_widths("trunks", hid_g, hid_c, C)
    lib = _cuda.lib("trunks")
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_scr = lib.hp_trunks_scratch_floats(n, C, hid_g, emb_c, hid_c,
                                         n_blocks, int(with_color),
                                         int(backward), int(wgrads))
    scratch = torch.empty((n_scr,), dtype=torch.float32, device=dev)
    occ = rgb = dp = dcg = dcc = wpart = None
    dcol = []
    wsplits = 1
    if backward:
        dp = torch.empty((n, 3), dtype=torch.float32, device=dev)
        dcg = torch.empty((n, C), dtype=torch.float32, device=dev)
        dcc = torch.empty((n, C), dtype=torch.float32, device=dev)
        if wgrads:
            dcol = [torch.empty_like(w) for w in col_flat]
            wsplits, wpart = _wgrad_partials(col_flat, n, dev)
    else:
        occ = torch.empty((n,), dtype=torch.float32, device=dev)
        rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    rc = lib.hp_trunks(
        p.data_ptr(), c_geo.data_ptr(),
        (c_col if with_color else c_geo).data_ptr(), Bg.data_ptr(),
        (Bc if with_color else Bg).data_ptr(), _ptr_array(geo_flat),
        _ptr_array(col_flat if with_color else geo_flat), n, C, emb_g, hid_g,
        emb_c, hid_c, n_blocks, skip, int(with_color), int(backward),
        int(need_dp), int(wgrads), ptr(g_occ), ptr(g_rgb),
        scratch.data_ptr(), ptr(occ), ptr(rgb), ptr(dp), ptr(dcg), ptr(dcc),
        _ptr_array(dcol) if dcol else None, ptr(wpart), wsplits, stream)
    _cuda.check(rc, "trunks")
    if not backward:
        return occ, rgb
    return dp, dcg, dcc, (dcol if wgrads else None)


def _check_trunks(p, c_geo, c_col, Bs, geo_flat, col_flat, n_blocks,
                  with_color):
    dev = p.device
    n = p.shape[0]
    _check("p", p, (n, 3), dev, "trunks")
    _check("c_geo", c_geo, (n, c_geo.shape[1]), dev, "trunks")
    if with_color:
        _check("c_col", c_col, c_geo.shape, dev, "trunks")
    for name, t in [("Bg", Bs[0])] + ([("Bc", Bs[1])] if with_color else []) \
            + [("geo weight", w) for w in geo_flat] \
            + [("col weight", w) for w in col_flat]:
        _check(name, t, None, dev, "trunks")
    if len(geo_flat) != 4 * n_blocks + 2 or (
            with_color and len(col_flat) != 4 * n_blocks + 2):
        raise ValueError("trunks: core weights must follow flatten_core")
    if n_blocks > 8:
        raise ValueError("trunks kernel supports n_blocks <= 8")


class _FusedTrunks(torch.autograd.Function):
    """Kernel #4 forward, kernel #5 backward (plain versions on the CPU).
    Differentiable in p (zero unless need_dp), c_geo, c_col and, with
    need_wgrads, the colour-core weights; the geometry core and both Bs get
    no gradient (zero), as in the reference."""

    @staticmethod
    def forward(ctx, cfg, p, c_geo, c_col, Bg, Bc, n_geo, *flat):
        geo_flat, col_flat = flat[:n_geo], flat[n_geo:]
        args = (p, c_geo, c_col, (Bg, Bc), geo_flat, col_flat,
                cfg["n_blocks"], cfg["skip"], cfg["with_color"])
        if p.device.type == "cpu":
            occ, rgb = fused_trunks_plain(*args)
        else:
            _cuda.LAUNCHES["trunks_fwd"] += 1
            occ, rgb = launch_trunks(*args, backward=False)
        ctx.cfg, ctx.n_geo = cfg, n_geo
        ctx.save_for_backward(p, c_geo, c_col, Bg, Bc, *flat)
        return occ, rgb

    @staticmethod
    def backward(ctx, g_occ, g_rgb):
        p, c_geo, c_col, Bg, Bc, *flat = ctx.saved_tensors
        cfg, n_geo = ctx.cfg, ctx.n_geo
        geo_flat, col_flat = flat[:n_geo], flat[n_geo:]
        need = ctx.needs_input_grad
        need_wgrads = cfg["need_wgrads"] and any(need[7 + n_geo:])
        args = (p, c_geo, c_col, (Bg, Bc), geo_flat, col_flat,
                g_occ.contiguous(), g_rgb.contiguous(), cfg["n_blocks"],
                cfg["skip"], cfg["with_color"], cfg["need_dp"] and need[1],
                need_wgrads)
        if p.device.type == "cpu":
            dp, dcg, dcc, dcol = fused_trunks_plain_bwd(*args)
        else:
            _cuda.LAUNCHES["trunks_bwd"] += 1
            dp, dcg, dcc, dcol = launch_trunks(
                *args[:6], *args[8:11], backward=True, g_occ=args[6],
                g_rgb=args[7], need_dp=args[11], need_wgrads=need_wgrads)
        return (None, dp, dcg, dcc if cfg["with_color"] else None, None,
                None, None, *([None] * n_geo),
                *(dcol if dcol is not None else [None] * len(col_flat)))


def _fused_trunks(p, c_geo, c_col, geo_flat, col_flat, Bs, n_blocks, skip,
                  with_color, need_dp, need_wgrads):
    p, c_geo = p.contiguous(), c_geo.contiguous()
    if c_col is not None:
        c_col = c_col.contiguous()
    if p.device.type == "cuda":
        _check_trunks(p, c_geo, c_col, Bs, geo_flat, col_flat, n_blocks,
                      with_color)
    elif p.device.type != "cpu":
        raise ValueError(f"trunks: unsupported device {p.device}")
    cfg = dict(n_blocks=n_blocks, skip=skip, with_color=with_color,
               need_dp=need_dp, need_wgrads=need_wgrads)
    return _FusedTrunks.apply(cfg, p, c_geo, c_col, Bs[0], Bs[1],
                              len(geo_flat), *geo_flat, *col_flat)


def nicer_fused_color(p, c_geo, c_col, geo_core_flat, col_core_flat, Bs,
                      n_blocks: int, skip: int, need_dp: bool = True,
                      need_wgrads: bool = True):
    """(occ_logit (n,), raw rgb (n, 3)) of one colour stage.

    Differentiable in p (with need_dp), c_geo, c_col and (with need_wgrads)
    the colour core weights; the geometry core and both Fourier Bs get zero
    cotangents (frozen, as in the reference)."""
    return _fused_trunks(p, c_geo, c_col, _weights_of(geo_core_flat),
                         _weights_of(col_core_flat), Bs, n_blocks, skip,
                         True, need_dp, need_wgrads)


def nicer_fused_geo(p, c_geo, geo_core_flat, Bg, n_blocks: int, skip: int,
                    need_dp: bool = True):
    """occ_logit (n,) of one geometry stage; differentiable in p (with
    need_dp) and c_geo only."""
    occ, _ = _fused_trunks(p, c_geo, None, _weights_of(geo_core_flat), (),
                           (Bg, None), n_blocks, skip, False, need_dp,
                           False)
    return occ


# ---------------------------------------------------------------------------
# Fused tracker render: nicer_fused_trackloss (kernels #8 and #9,
# csrc/trackloss.cu).  Per-stage constants (tracker.stage_knn):
#   rowc  (n, 2S+6+3SK)  [z S | d_gt 1 | c_gt 3 | r2 1 | has S | nz 1 |
#                         cpos SK*3]
#   cfeat (n, SK*2C)     cached neighbour features [geo C | col C] per slot
# per iteration: rays (n, 6) [o | d], aff (n, 12) exposure affine rows.

def trackrow_offsets(S: int, K: int) -> dict:
    return {"z": 0, "d_gt": S, "c_gt": S + 1, "r2": S + 4, "has": S + 5,
            "nz": 2 * S + 5, "cpos": 2 * S + 6}


def trackloss_plain(rays, aff, rowc, cfeat, geo_flat, col_flat, Bs,
                    n_blocks: int, skip: int, S: int, K: int, C: int,
                    coef: float, wmode: int, use_affine: bool,
                    sigmoid_plain: bool):
    """Plain version of the fused tracker render: (depth (n,), var (n,),
    color (n, 3)), differentiable in rays and aff by autograd.  In-kernel
    interpolation weights (wmode 0: 1/(d^2+1e-10), 1: exp(-20 d)) inside
    r^2, both trunks, the per-sample exposure affine + sigmoid (or plain
    sigmoid) tail and the occupancy compositor."""
    Bg, Bc = Bs
    n = rays.shape[0]
    o = trackrow_offsets(S, K)
    z = rowc[:, :S]
    r2 = rowc[:, o["r2"]:o["r2"] + 1]
    has = rowc[:, o["has"]:o["has"] + S] > 0.5
    cpos = rowc[:, o["cpos"]:o["cpos"] + 3 * S * K].reshape(n, S, K, 3)
    pts = rays[:, None, :3] + z[..., None] * rays[:, None, 3:]
    dd = torch.sum(torch.square(cpos - pts[:, :, None]), -1)    # (n, S, K)
    inr = dd <= r2[..., None]
    if wmode == 0:
        w = torch.where(inr, 1.0 / (dd + 1e-10), 0.0)
    else:
        w = torch.where(inr, torch.exp(-20.0 * torch.sqrt(
            torch.clamp(dd, min=1e-12))), 0.0)
    wn = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-12)
    c = torch.sum(wn[..., None] * cfeat.reshape(n, S, K, 2 * C), 2)
    c = torch.where(has[..., None], c, 0.0).reshape(n * S, 2 * C)
    p = pts.reshape(n * S, 3)
    occ = _trunk(fourier_features(p, Bg, concat_cos=False), c[:, :C],
                 geo_flat, n_blocks, skip, torch.relu)[:, 0].reshape(n, S)
    raw = _trunk(fourier_features(p, Bc, concat_cos=True), c[:, C:],
                 col_flat, n_blocks, skip, softplus100).reshape(n, S, 3)
    if use_affine:
        a = aff[:, None, :]
        rgb = torch.sigmoid(torch.stack([
            raw[..., 0] * a[..., d] + raw[..., 1] * a[..., 3 + d]
            + raw[..., 2] * a[..., 6 + d] + a[..., 9 + d]
            for d in range(3)], -1))
    elif sigmoid_plain:
        rgb = torch.sigmoid(raw)
    else:
        rgb = raw
    alpha = torch.sigmoid(coef * torch.where(has, occ, -100.0))
    ts, t_run = [], torch.ones_like(alpha[:, 0])
    for s in range(S):
        ts.append(t_run)
        t_run = t_run * ((1.0 - alpha[:, s]) + 1e-10)
    wc = alpha * torch.stack(ts, 1)
    wsum = torch.sum(wc, 1) + 1e-10
    depth = torch.sum(wc * z, 1) / wsum
    color = torch.sum(wc[..., None] * rgb, 1) / wsum[:, None]
    var = torch.sum(wc * torch.square(z - depth[:, None]), 1)
    return depth, var, color


def launch_trackloss(rays, aff, rowc, cfeat, geo_flat, col_flat, Bs,
                     n_blocks, skip, S, K, C, coef, wmode, use_affine,
                     sigmoid_plain, backward: bool, g_depth=None,
                     g_color=None):
    """Run kernel #8 (backward=False): (depth, var, color); or #9: (drays,
    daff)."""
    Bg, Bc = Bs
    n, Dr = rowc.shape
    dev = rays.device
    hid_g, hid_c = geo_flat[0].shape[1], col_flat[0].shape[1]
    emb_g, emb_c = Bg.shape[1], 2 * Bc.shape[1]
    _check_tc_widths("trackloss", hid_g, hid_c, C)
    lib = _cuda.lib("trackloss")
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_scr = lib.hp_trackloss_scratch_floats(n, S, hid_g, hid_c, n_blocks,
                                            int(backward))
    scratch = torch.empty((n_scr,), dtype=torch.float32, device=dev)

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = ((None, None, None, new(n, 6), new(n, 12)) if backward
            else (new(n), new(n), new(n, 3), None, None))
    rc = lib.hp_trackloss(
        rays.data_ptr(), rowc.data_ptr(), Dr, cfeat.data_ptr(),
        aff.data_ptr(), Bg.data_ptr(), Bc.data_ptr(), _ptr_array(geo_flat),
        _ptr_array(col_flat), n, S, K, C, emb_g, hid_g, emb_c, hid_c,
        n_blocks, skip, float(coef), int(wmode), int(use_affine),
        int(sigmoid_plain), int(backward),
        g_depth.data_ptr() if backward else None,
        g_color.data_ptr() if backward else None, scratch.data_ptr(),
        *[t.data_ptr() if t is not None else None for t in outs], stream)
    _cuda.check(rc, "trackloss")
    return outs[3:] if backward else outs[:3]


class _TrackLoss(torch.autograd.Function):
    """Kernel #8 forward, kernel #9 backward; differentiable in rays and
    aff (var carries no gradient; the cache rows, features, weights and Bs
    get none, i.e. zero, as in the reference)."""

    @staticmethod
    def forward(ctx, cfg, rays, aff, rowc, cfeat, Bg, Bc, n_geo, *flat):
        _cuda.LAUNCHES["trackloss_fwd"] += 1
        depth, var, color = launch_trackloss(
            rays, aff, rowc, cfeat, flat[:n_geo], flat[n_geo:], (Bg, Bc),
            backward=False, **cfg)
        ctx.cfg, ctx.n_geo = cfg, n_geo
        ctx.save_for_backward(rays, aff, rowc, cfeat, Bg, Bc, *flat)
        ctx.mark_non_differentiable(var)
        return depth, var, color

    @staticmethod
    def backward(ctx, g_depth, _g_var, g_color):
        rays, aff, rowc, cfeat, Bg, Bc, *flat = ctx.saved_tensors
        n_geo = ctx.n_geo
        _cuda.LAUNCHES["trackloss_bwd"] += 1
        drays, daff = launch_trackloss(
            rays, aff, rowc, cfeat, flat[:n_geo], flat[n_geo:], (Bg, Bc),
            backward=True, g_depth=g_depth.contiguous(),
            g_color=g_color.contiguous(), **ctx.cfg)
        return (None, drays, daff) + (None,) * (5 + len(flat))


def nicer_fused_trackloss(rays, aff, rowc, cfeat, geo_flat, col_flat, Bs,
                          n_blocks: int, skip: int, S: int, K: int, C: int,
                          coef: float, wmode: int, use_affine: bool,
                          sigmoid_plain: bool = False):
    """Fused tracker render: (depth (n,), var (n,), color (n, 3)).

    Differentiable in ``rays`` (n, 6 = [o | d]) and ``aff`` (n, 12); the
    cache rows, neighbour features, decoder weights and Fourier Bs are
    constants.  ``var`` carries no gradient.  CPU tensors take
    trackloss_plain on the detached constants."""
    geo_flat, col_flat = _weights_of(geo_flat), _weights_of(col_flat)
    rays, aff = rays.contiguous(), aff.contiguous()
    cfg = dict(n_blocks=n_blocks, skip=skip, S=S, K=K, C=C, coef=coef,
               wmode=wmode, use_affine=use_affine,
               sigmoid_plain=sigmoid_plain)
    dev = rays.device
    if cfeat.dtype != torch.float32:
        raise ValueError("trackloss: cfeat must be float32 (bf16 features "
                         "belong to model.mm_bf16, which is not ported)")
    if dev.type == "cpu":
        const = [t.detach() for t in geo_flat + col_flat]
        d, v, c = trackloss_plain(
            rays, aff, rowc.detach(), cfeat.detach(), const[:len(geo_flat)],
            const[len(geo_flat):], (Bs[0].detach(), Bs[1].detach()), **cfg)
        return d, v.detach(), c
    if dev.type != "cuda":
        raise ValueError(f"trackloss: unsupported device {dev}")
    n = rays.shape[0]
    _check("rays", rays, (n, 6), dev, "trackloss")
    _check("aff", aff, (n, 12), dev, "trackloss")
    _check("rowc", rowc, (n, 2 * S + 6 + 3 * S * K), dev, "trackloss")
    _check("cfeat", cfeat, (n, S * K * 2 * C), dev, "trackloss")
    for name, t in [("Bg", Bs[0]), ("Bc", Bs[1])] \
            + [("weight", w) for w in geo_flat + col_flat]:
        _check(name, t, None, dev, "trackloss")
    if len(geo_flat) != 4 * n_blocks + 2 or len(col_flat) != 4 * n_blocks + 2:
        raise ValueError("trackloss: core weights must follow flatten_core")
    if S > 16 or K > 16 or n_blocks > 8:
        raise ValueError("trackloss kernel supports S, K <= 16, "
                         "n_blocks <= 8")
    if torch.is_grad_enabled() and (rays.requires_grad or aff.requires_grad):
        return _TrackLoss.apply(cfg, rays, aff, rowc, cfeat, Bs[0], Bs[1],
                                len(geo_flat), *geo_flat, *col_flat)
    _cuda.LAUNCHES["trackloss_fwd"] += 1
    return launch_trackloss(rays, aff, rowc, cfeat, geo_flat, col_flat, Bs,
                            backward=False, **cfg)




# ---------------------------------------------------------------------------
# Fused composite: nicer_fused_composite (kernel #6 forward, csrc/composite.cu;
# the reference's _ncomp_bwd backward: comp_bwd, then kernel #5) and the
# fully fused backward fused_comp_bwd (kernel #7).  Per ray: S sample rows
# (p, c_geo, c_col) and the ray's z (n_r, S) and pm (n_r, S, 0/1 floats).

def comp_fwd(occ, rgb, z, pm, coef: float):
    """The reference's in-kernel occupancy compositor (`_comp_fwd` :227):
    (n, S) occ logits, (n, S, 3) rgb, (n, S) z, (n, S) bool pm -> (depth
    (n,), var (n,), color (n, 3), residuals for comp_bwd)."""
    S = occ.shape[1]
    a = torch.sigmoid(coef * torch.where(pm, occ, -100.0))
    ts = [torch.ones_like(a[:, 0])]
    for s in range(1, S):
        ts.append(ts[-1] * (1.0 - a[:, s - 1] + 1e-10))
    t = torch.stack(ts, 1)
    w = a * t
    wsum = torch.sum(w, 1) + 1e-10
    color = torch.sum(w[..., None] * rgb, 1) / wsum[:, None]
    depth = torch.sum(w * z, 1) / wsum
    dv = z - depth[:, None]
    var = torch.sum(w * dv * dv, 1)
    return depth, var, color, (a, t, w, wsum, depth, color)


def comp_bwd(res, z, rgb, pm, coef: float, dD, dV, dC):
    """The reference's hand-written compositor backward (`_comp_bwd` :246):
    (d occ (n, S), d rgb (n, S, 3)); z and pm are constants."""
    a, t, w, wsum, depth, color = res
    S = a.shape[1]
    dv = z - depth[:, None]
    dD_eff = dD + dV * (-2.0 * torch.sum(w * dv, 1))
    dw = (dD_eff[:, None] * dv / wsum[:, None]
          + torch.sum(dC[:, None, :] * (rgb - color[:, None, :]), -1)
          / wsum[:, None]
          + dV[:, None] * dv * dv)
    drgb = dC[:, None, :] * (w / wsum[:, None])[..., None]
    da = [None] * S
    suffix = torch.zeros_like(a[:, 0])            # sum_{u>s} dw_u w_u
    for s in range(S - 1, -1, -1):
        da[s] = dw[:, s] * t[:, s] - suffix / (1.0 - a[:, s] + 1e-10)
        suffix = suffix + dw[:, s] * w[:, s]
    docc = torch.stack(da, 1) * coef * a * (1.0 - a)
    return torch.where(pm, docc, 0.0), drgb


def comp_cotangents(occ, rgb, z, pm, coef: float, dD, dV, dC,
                    sigmoid_rgb: bool):
    """Per-sample trunk cotangents (g_occ (n_r*S,), g_rgb (n_r*S, 3)) from
    the per-ray ones, on the forward's saved occ and rgb (post-sigmoid with
    sigmoid_rgb), as `_ncomp_bwd` :863 chains them."""
    n_r, S = z.shape
    pmb = pm > 0.5
    rgb_r = rgb.reshape(n_r, S, 3)
    *_, res = comp_fwd(occ.reshape(n_r, S), rgb_r, z, pmb, coef)
    docc, drgb = comp_bwd(res, z, rgb_r, pmb, coef, dD, dV, dC)
    g_rgb = drgb.reshape(-1, 3)
    if sigmoid_rgb:
        g_rgb = g_rgb * rgb * (1.0 - rgb)
    return docc.reshape(-1), g_rgb


def composite_plain(p, c_geo, c_col, z, pm, Bs, geo_flat, col_flat,
                    n_blocks: int, skip: int, with_color: bool, S: int,
                    coef: float, sigmoid_rgb: bool):
    """Plain version of kernel #6: (depth (n_r,), var (n_r,), color
    (n_r, 3), occ (n_r*S,) logits, rgb (n_r*S, 3), post-sigmoid with
    sigmoid_rgb and colour, zero without colour)."""
    occ, rgb = fused_trunks_plain(p, c_geo, c_col, Bs, geo_flat, col_flat,
                                  n_blocks, skip, with_color)
    if with_color and sigmoid_rgb:
        rgb = torch.sigmoid(rgb)
    n_r = z.shape[0]
    d, v, c, _ = comp_fwd(occ.reshape(n_r, S), rgb.reshape(n_r, S, 3), z,
                          pm > 0.5, coef)
    return d, v, c, occ, rgb


def composite_bwd_plain(p, c_geo, c_col, z, pm, Bs, geo_flat, col_flat, dD,
                        dV, dC, n_blocks: int, skip: int, with_color: bool,
                        S: int, coef: float, need_wgrads: bool,
                        sigmoid_rgb: bool):
    """Plain version of kernel #7, the composition `_ncomp_bwd` runs: the
    forward, comp_bwd, the sigmoid chain and the trunk backward without dp.
    Returns (dc_geo, dc_col, colour-core weight grads, zero unless colour
    and need_wgrads)."""
    *_, occ, rgb = composite_plain(p, c_geo, c_col, z, pm, Bs, geo_flat,
                                   col_flat, n_blocks, skip, with_color, S,
                                   coef, sigmoid_rgb)
    g_occ, g_rgb = comp_cotangents(occ, rgb, z, pm, coef, dD, dV, dC,
                                   sigmoid_rgb and with_color)
    _dp, dcg, dcc, dcol = fused_trunks_plain_bwd(
        p, c_geo, c_col, Bs, geo_flat, col_flat, g_occ, g_rgb, n_blocks,
        skip, with_color, False, with_color and need_wgrads)
    if dcol is None:
        dcol = [torch.zeros_like(w) for w in col_flat]
    return dcg, dcc, dcol


def launch_composite(p, c_geo, c_col, z, pm, Bs, geo_flat, col_flat,
                     n_blocks, skip, with_color, S, coef, sigmoid_rgb,
                     backward: bool = False, dD=None, dV=None, dC=None,
                     need_wgrads: bool = False):
    """Run kernel #6 (backward=False): (depth, var, color, occ, rgb); or #7:
    (dcg, dcc, colour-core weight grads or None)."""
    Bg, Bc = Bs
    n_r = z.shape[0]
    n = n_r * S
    C = c_geo.shape[1]
    dev = p.device
    hid_g, emb_g = geo_flat[0].shape[1], Bg.shape[1]
    hid_c = col_flat[0].shape[1] if with_color else hid_g
    emb_c = 2 * Bc.shape[1] if with_color else emb_g
    _check_tc_widths("composite", hid_g, hid_c, C)
    lib = _cuda.lib("composite")
    stream = torch.cuda.current_stream(dev).cuda_stream
    wgrads = bool(backward and with_color and need_wgrads)
    n_scr = lib.hp_composite_scratch_floats(n, C, hid_g, emb_c, hid_c,
                                            n_blocks, int(with_color),
                                            int(backward), int(wgrads))
    scratch = torch.empty((n_scr,), dtype=torch.float32, device=dev)

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    occ, rgb = new(n), new(n, 3)
    d = v = c = dcg = dcc = wpart = None
    dcol = []
    wsplits = 1
    if backward:
        dcg, dcc = new(n, C), new(n, C)
        if wgrads:
            dcol = [torch.empty_like(w) for w in col_flat]
            wsplits, wpart = _wgrad_partials(col_flat, n, dev)
    else:
        d, v, c = new(n_r), new(n_r), new(n_r, 3)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    rc = lib.hp_composite(
        p.data_ptr(), c_geo.data_ptr(),
        (c_col if with_color else c_geo).data_ptr(), z.data_ptr(),
        pm.data_ptr(), Bg.data_ptr(), (Bc if with_color else Bg).data_ptr(),
        _ptr_array(geo_flat), _ptr_array(col_flat if with_color
                                         else geo_flat),
        n_r, S, C, emb_g, hid_g, emb_c, hid_c, n_blocks, skip,
        int(with_color), float(coef), int(sigmoid_rgb), int(backward),
        int(wgrads), ptr(dD), ptr(dV), ptr(dC), scratch.data_ptr(), ptr(d),
        ptr(v), ptr(c), occ.data_ptr(), rgb.data_ptr(), ptr(dcg), ptr(dcc),
        _ptr_array(dcol) if dcol else None, ptr(wpart), wsplits, stream)
    _cuda.check(rc, "composite")
    if not backward:
        return d, v, c, occ, rgb
    return dcg, dcc, (dcol if wgrads else None)


def _check_composite(p, c_geo, c_col, z, pm, Bs, geo_flat, col_flat,
                     n_blocks, with_color, S):
    _check_trunks(p, c_geo, c_col, Bs, geo_flat, col_flat, n_blocks,
                  with_color)
    n_r = z.shape[0]
    _check("z", z, (n_r, S), p.device, "composite")
    _check("pm", pm, (n_r, S), p.device, "composite")
    if p.shape[0] != n_r * S:
        raise ValueError(f"composite: {p.shape[0]} sample rows for {n_r} "
                         f"rays of {S} samples")
    if S > 16:
        raise ValueError("composite kernel supports S <= 16 (HP_MAXS)")


def _composite_args(c_geo, c_col, p, z, pm, Bs, with_color):
    c_geo, p, z, pm = (t.contiguous() for t in (c_geo, p, z, pm))
    c_col = c_col.contiguous() if with_color else None
    return c_geo, c_col, p, z, pm, (Bs[0].contiguous(),
                                    Bs[1].contiguous() if with_color
                                    else Bs[1])


class _FusedComposite(torch.autograd.Function):
    """Kernel #6 forward (composite_plain on the CPU); backward as the
    reference's `_ncomp_bwd`: comp_cotangents on the saved occ / rgb, then
    the trunk backward without dp (kernel #5, or fused_trunks_plain_bwd on
    the CPU).  Differentiable in c_geo, c_col and, with need_wgrads and
    colour, the colour-core weights; p, z, pm, the geometry core and both
    Bs get no gradient (zero), as in the reference."""

    @staticmethod
    def forward(ctx, cfg, c_geo, c_col, p, z, pm, Bg, Bc, n_geo, *flat):
        geo_flat, col_flat = flat[:n_geo], flat[n_geo:]
        args = (p, c_geo, c_col, z, pm, (Bg, Bc), geo_flat, col_flat,
                cfg["n_blocks"], cfg["skip"], cfg["with_color"], cfg["S"],
                cfg["coef"], cfg["sigmoid_rgb"])
        if p.device.type == "cpu":
            d, v, c, occ, rgb = composite_plain(*args)
        else:
            _cuda.LAUNCHES["composite_fwd"] += 1
            d, v, c, occ, rgb = launch_composite(*args)
        ctx.cfg, ctx.n_geo = cfg, n_geo
        ctx.save_for_backward(p, c_geo, c_col, z, pm, Bg, Bc, occ, rgb,
                              *flat)
        return d, v, c

    @staticmethod
    def backward(ctx, dD, dV, dC):
        p, c_geo, c_col, z, pm, Bg, Bc, occ, rgb, *flat = ctx.saved_tensors
        cfg, n_geo = ctx.cfg, ctx.n_geo
        geo_flat, col_flat = flat[:n_geo], flat[n_geo:]
        with_color = cfg["with_color"]
        g_occ, g_rgb = comp_cotangents(occ, rgb, z, pm, cfg["coef"], dD, dV,
                                       dC, cfg["sigmoid_rgb"] and with_color)
        need_wgrads = (cfg["need_wgrads"] and with_color
                       and any(ctx.needs_input_grad[9 + n_geo:]))
        args = (p, c_geo, c_col, (Bg, Bc), geo_flat, col_flat)
        if p.device.type == "cpu":
            _dp, dcg, dcc, dcol = fused_trunks_plain_bwd(
                *args, g_occ, g_rgb, cfg["n_blocks"], cfg["skip"],
                with_color, False, need_wgrads)
        else:
            _cuda.LAUNCHES["trunks_bwd"] += 1
            _dp, dcg, dcc, dcol = launch_trunks(
                *args, cfg["n_blocks"], cfg["skip"], with_color,
                backward=True, g_occ=g_occ.contiguous(),
                g_rgb=g_rgb.contiguous(), need_dp=False,
                need_wgrads=need_wgrads)
        return (None, dcg, dcc if with_color else None) + (None,) * 6 \
            + (None,) * n_geo \
            + tuple(dcol if dcol is not None else [None] * len(col_flat))


def nicer_fused_composite(c_geo, c_col, p, z, pm, geo_core_flat,
                          col_core_flat, Bs, n_blocks: int, skip: int,
                          with_color: bool, S: int, coef: float,
                          need_wgrads: bool = True,
                          sigmoid_rgb: bool = False):
    """Both trunks and the occupancy compositor per ray: (depth (n_r,),
    depth variance (n_r,), composited colour (n_r, 3); zero colour without
    colour).  ``rgb`` is composited post-sigmoid with sigmoid_rgb, raw
    otherwise (exposure applies outside).

    Differentiable in c_geo, c_col and (with need_wgrads and colour) the
    colour core weights; p (n_r*S, 3), z (n_r, S), pm (n_r, S; 0/1 floats),
    the geometry core and both Fourier Bs get zero cotangents (phase
    constants, frozen), as in the reference.  c_col may be None without
    colour."""
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"composite: unsupported device {p.device}")
    geo_flat = _weights_of(geo_core_flat)
    col_flat = _weights_of(col_core_flat) if with_color else []
    c_geo, c_col, p, z, pm, Bs = _composite_args(c_geo, c_col, p, z, pm, Bs,
                                                 with_color)
    if p.device.type == "cuda":
        _check_composite(p, c_geo, c_col, z, pm, Bs, geo_flat, col_flat,
                         n_blocks, with_color, S)
    cfg = dict(n_blocks=n_blocks, skip=skip, with_color=with_color, S=S,
               coef=coef, sigmoid_rgb=sigmoid_rgb, need_wgrads=need_wgrads)
    return _FusedComposite.apply(cfg, c_geo, c_col, p, z, pm, Bs[0], Bs[1],
                                 len(geo_flat), *geo_flat, *col_flat)


def fused_comp_bwd(p, c_geo, c_col, z, pm, Bs, geo_core_flat, col_core_flat,
                   dD, dV, dC, n_blocks: int, skip: int, with_color: bool,
                   S: int, coef: float, need_wgrads: bool,
                   sigmoid_rgb: bool = False):
    """The fully fused backward of nicer_fused_composite (the reference's
    `_fused_comp_bwd` :756): (dc_geo, dc_col, colour-core weight grads,
    zero unless colour and need_wgrads).  Kernel #7 on CUDA tensors,
    composite_bwd_plain on CPU tensors.  No path calls it, as in the
    reference, whose VJP composes comp_bwd and the trunk backward instead
    (nicer_fused_composite's backward here)."""
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"composite: unsupported device {p.device}")
    geo_flat = _weights_of(geo_core_flat)
    col_flat = _weights_of(col_core_flat) if with_color else []
    c_geo, c_col, p, z, pm, Bs = _composite_args(c_geo, c_col, p, z, pm, Bs,
                                                 with_color)
    dD, dV, dC = (t.contiguous() for t in (dD, dV, dC))
    args = (p, c_geo, c_col, z, pm, Bs, geo_flat, col_flat)
    if p.device.type == "cpu":
        return composite_bwd_plain(*args, dD, dV, dC, n_blocks, skip,
                                   with_color, S, coef, need_wgrads,
                                   sigmoid_rgb)
    _check_composite(*args, n_blocks, with_color, S)
    n_r = z.shape[0]
    for name, t, shape in (("dD", dD, (n_r,)), ("dV", dV, (n_r,)),
                           ("dC", dC, (n_r, 3))):
        _check(name, t, shape, p.device, "composite")
    _cuda.LAUNCHES["composite_bwd"] += 1
    dcg, dcc, dcol = launch_composite(
        *args, n_blocks, skip, with_color, S, coef, sigmoid_rgb,
        backward=True, dD=dD, dV=dV, dC=dC, need_wgrads=need_wgrads)
    if dcol is None:
        dcol = [torch.zeros_like(w) for w in col_core_flat]
    if not with_color:
        dcc = torch.zeros_like(c_geo)
    return dcg, dcc, dcol
