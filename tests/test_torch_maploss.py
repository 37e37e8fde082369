"""Mapping loss of the PyTorch port (plain version, autograd backward)
against hpslam_tpu's nicer_fused_maploss, whose Pallas kernel pair runs in
interpret mode on the CPU.  Same inputs through both; forward losses and
every cotangent (d uf, d aff, d colour-core weights) compared.

Tolerance: rtol 2e-4 / atol 2e-5 on f32 (tighter than
tests/test_fused_mlp.py's 3e-3 / 3e-4): the two sides order the trunk
matmul sums and the Fourier projection differently.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpslam_tpu.models import decoder as jDec
from hpslam_tpu.ops import fused_mlp as jFM
from hpslam_tpu_torch import convert
from hpslam_tpu_torch.ops import fused_mlp as tFM


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two torch threads per test: the suite runs in several processes at
    once, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

RTOL, ATOL = 2e-4, 2e-5


def _inputs(rng, n, S, u, C, with_color):
    z = (1.5 + rng.uniform(0, 1, (n, 1))) * np.linspace(0.96, 1.04, S)
    rd = rng.normal(size=(n, 3))
    pts = rd[:, None] * z[..., None] + 0.01 * rng.normal(size=(n, S, 3))
    d_gt = z[:, S // 2:S // 2 + 1] * (1 + 0.02 * rng.normal(size=(n, 1)))
    c_gt = rng.uniform(size=(n, 3))
    pm = (rng.uniform(size=(n, S)) > 0.15).astype(np.float64)
    Wm = rng.uniform(size=(n, S, u))
    Wm = (Wm / Wm.sum(-1, keepdims=True)).reshape(n, S * u)
    uids = rng.integers(0, 50, (n, u)).astype(np.float64)
    row = np.concatenate([z, pts.reshape(n, 3 * S), rd, d_gt, c_gt, pm, Wm,
                          uids], 1).astype(np.float32)
    fs = 2 * C if with_color else C
    uf = rng.normal(0, 0.2, (n, u * fs)).astype(np.float32)
    okf = (rng.uniform(size=(n, 1)) > 0.1).astype(np.float32)
    aff = np.concatenate([np.tile(np.eye(3).reshape(1, 9), (n, 1))
                          + 0.05 * rng.normal(size=(n, 9)),
                          0.05 * rng.normal(size=(n, 3))], 1
                         ).astype(np.float32)
    return row, uf, okf, aff


@pytest.mark.parametrize("with_color,use_aff", [(True, False), (True, True),
                                                (False, False)],
                         ids=["color", "color+affine", "geometry"])
def test_maploss_matches_pallas_reference(rng, with_color, use_aff):
    cfg = jDec.ModelConfig(c_dim=8, geo_embed=16, col_embed=8, rel_embed=4,
                           hidden_geo=16, hidden_col=32)
    params = jDec.init_nicer(jax.random.PRNGKey(5), cfg)
    n, S, u, C = 40, 5, 4, cfg.c_dim
    row, uf, okf, aff = _inputs(rng, n, S, u, C, with_color)
    gd, cd = params["geo_fine"], params["col_fine"]
    geo_flat = tuple(jFM.flatten_core(gd["core"]))
    col_flat = tuple(jFM.flatten_core(cd["core"]))
    w_color = 0.1
    static = (cfg.n_blocks, cfg.skip, with_color, S, u, C, 0.1,
              not use_aff, use_aff, w_color)

    def lj(uf_, aff_, col_):
        gl, cl = jFM.nicer_fused_maploss(
            uf_, aff_, col_, jnp.asarray(row), jnp.asarray(okf), geo_flat,
            (gd["B"], cd["B"]), *static, need_wgrads=True)
        total = gl + w_color * cl if with_color else gl
        return total, (gl, cl)

    (_, (gl_j, cl_j)), g_j = jax.value_and_grad(
        lj, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(uf), jnp.asarray(aff), col_flat)

    tp = convert.params_from_numpy(jax.tree.map(np.asarray, params))
    geo_t = tFM.flatten_core(tp["geo_fine"]["core"])
    col_t = [w.requires_grad_() for w in
             tFM.flatten_core(tp["col_fine"]["core"])]
    uf_t = torch.tensor(uf, requires_grad=True)
    aff_t = torch.tensor(aff, requires_grad=True)
    gl_t, cl_t = tFM.nicer_fused_maploss(
        uf_t, aff_t, col_t, torch.tensor(row), torch.tensor(okf), geo_t,
        (tp["geo_fine"]["B"], tp["col_fine"]["B"]), cfg.n_blocks, cfg.skip,
        with_color, S, u, C, 0.1, not use_aff, use_aff, w_color)
    total = gl_t + w_color * cl_t if with_color else gl_t
    total.backward()

    np.testing.assert_allclose(float(gl_t.detach()), float(gl_j), rtol=RTOL)
    np.testing.assert_allclose(float(cl_t.detach()), float(cl_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(uf_t.grad.numpy(), np.asarray(g_j[0]),
                               rtol=RTOL, atol=ATOL, err_msg="duf")
    if use_aff:
        np.testing.assert_allclose(aff_t.grad.numpy(), np.asarray(g_j[1]),
                                   rtol=RTOL, atol=ATOL, err_msg="daff")
    if with_color:
        for i, (a, b) in enumerate(zip(col_t, g_j[2])):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"dcol[{i}]")


def test_unported_fused_entry_points_raise():
    """Every fused entry point is ported now; the last two, the fused
    composite (kernel #6) and its fully fused backward (kernel #7), raise
    for a tensor on a device they do not run on, as the others do."""
    def meta(*shape):
        return torch.zeros(shape, device="meta")
    with pytest.raises(ValueError):
        tFM.nicer_fused_composite(meta(10, 8), None, meta(10, 3),
                                  meta(2, 5), meta(2, 5), [], [],
                                  (None, None), 5, 2, False, 5, 0.1)
    with pytest.raises(ValueError):
        tFM.fused_comp_bwd(meta(10, 3), meta(10, 8), None, meta(2, 5),
                           meta(2, 5), (None, None), [], [], meta(2),
                           meta(2), meta(2, 3), 5, 2, False, 5, 0.1, False)
