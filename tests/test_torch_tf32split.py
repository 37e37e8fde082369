"""The 3xTF32 arithmetic of the tensor-core trunk kernels (#3 and #5,
hpslam_tpu_torch/csrc/nicer_trunk_tc.cuh), emulated in plain PyTorch on the
CPU, against the port's f32 plain trunk and the reference's
_trunk_fwd_block / _trunk_bwd_block (hpslam_tpu/ops/fused_mlp.py) at
exact=True.

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
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpslam_tpu.ops import fused_mlp as jFM
from hpslam_tpu_torch.models.decoder import fourier_features, softplus100
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


@pytest.mark.parametrize("kernel", ["maploss", "trunks"])
def test_tensor_core_kernels_reject_widths_off_the_mma_grid(kernel):
    """Kernels #3 and #5 tile every width by the mma's 8: their launchers
    refuse a hidden width that is not a multiple of 8 before building or
    launching anything."""
    n, C, nb = 4, 8, 2
    geo = [torch.zeros(s) for s in [(16, 12), (12,), (28, 12), (12,)]
           + [(C, 12), (12,)] * nb + [(12, 1), (1,)]]
    col = [torch.zeros(s) for s in [(8, 16), (16,), (24, 16), (16,)]
           + [(C, 16), (16,)] * nb + [(16, 3), (3,)]]
    Bs = (torch.zeros((3, 16)), torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="multiples of 8"):
        if kernel == "maploss":
            S, u = 2, 2
            row = torch.zeros((n, 5 * S + 7 + S * u + u))
            tFM.launch_maploss(torch.zeros((n, u * 2 * C)),
                               torch.zeros((n, 12)), col, row,
                               torch.ones((n, 1)), geo, Bs, nb, 0, True, S,
                               u, C, 0.1, True, False, 0.1, backward=True,
                               need_wgrads=True)
        else:
            tFM.launch_trunks(torch.zeros((n, 3)), torch.zeros((n, C)),
                              torch.zeros((n, C)), Bs, geo, col, nb, 0, True,
                              backward=True, g_occ=torch.zeros(n),
                              g_rgb=torch.zeros((n, 3)))
