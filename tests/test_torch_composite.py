"""The fused composite of the PyTorch port (both trunks and the occupancy
compositor per ray, kernels #6-7) against hpslam_tpu's, whose Pallas
kernels run in interpret mode on the CPU (as tests/test_fused_mlp.py runs
them).  Same inputs, weights and per-ray cotangents through both:
nicer_fused_composite's values and its gradients of c_geo, c_col and the
colour core; the plain version of kernel #7 (the composition the
reference's VJP runs) against the reference's fully fused backward
`_fused_comp_bwd`; the written-out compositor backward against autograd.

Tolerance: rtol 2e-4 / atol 1e-4 on f32, as tests/test_torch_trunks.py
states it: the two sides order the trunk sums and the Fourier projection
differently (the projection reaches ~1e3 rad, where an f32 ulp is 6e-5).
The depth variance is a weighted sum of squared differences of values
~2 m apart by ~1 cm, so it is held at atol 1e-6 of its ~1e-4 scale
(rtol 2e-3, as the reference's own test_fused_composite_matches_chain).
"""
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


RTOL, ATOL = 2e-4, 1e-4
VAR_RTOL, VAR_ATOL = 2e-3, 1e-6
COEF = 0.1

CASES = [(True, True, True), (True, False, True), (False, False, True),
         (True, True, False)]
IDS = ["color+sigmoid", "color_raw", "geometry", "color_no_wgrads"]


def small_cfg():
    return jDec.ModelConfig(c_dim=8, geo_embed=16, col_embed=8, rel_embed=4,
                            hidden_geo=16, hidden_col=32)


def _setup(rng, n_r=48, S=5):
    """48 rays of 5 samples toward a wall ~2 m away, a fifth of the samples
    padded (pm = 0), seeded numpy inputs, weights carried by convert."""
    cfg = small_cfg()
    pj = jDec.init_nicer(jax.random.PRNGKey(5), cfg)
    pt = convert.params_from_numpy(jax.tree.map(np.asarray, pj))
    n = n_r * S
    rd = np.stack([rng.uniform(-0.5, 0.5, n_r), rng.uniform(-0.4, 0.4, n_r),
                   -np.ones(n_r)], -1)
    z = (rng.uniform(1.9, 2.1, (n_r, 1))
         * np.linspace(0.96, 1.04, S)[None]).astype(np.float32)
    p = (rd[:, None, :] * z[..., None]).reshape(n, 3).astype(np.float32)
    x = dict(
        p=p, z=z,
        pm=(rng.uniform(0, 1, (n_r, S)) > 0.2).astype(np.float32),
        cg=rng.normal(0, 0.3, (n, cfg.c_dim)).astype(np.float32),
        cc=rng.normal(0, 0.3, (n, cfg.c_dim)).astype(np.float32),
        dD=rng.normal(size=(n_r,)).astype(np.float32),
        dV=rng.normal(size=(n_r,)).astype(np.float32),
        dC=rng.normal(size=(n_r, 3)).astype(np.float32))
    return cfg, pj, pt, S, x


def _close(a, b, name, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("with_color,sigmoid_rgb,need_wgrads", CASES,
                         ids=IDS)
def test_composite_matches_pallas_reference(rng, with_color, sigmoid_rgb,
                                            need_wgrads):
    cfg, pj, pt, S, x = _setup(rng)
    gd, cd = pj["geo_fine"], pj["col_fine"]
    geo_j = tuple(jFM.flatten_core(gd["core"]))
    col_j = tuple(jFM.flatten_core(cd["core"]))

    def fj(cg_, cc_, col_):
        return jFM.nicer_fused_composite(
            cg_, cc_, jnp.asarray(x["p"]), jnp.asarray(x["z"]),
            jnp.asarray(x["pm"]), geo_j, col_, (gd["B"], cd["B"]),
            cfg.n_blocks, cfg.skip, with_color, S, COEF, need_wgrads,
            sigmoid_rgb)

    (d_j, v_j, c_j), vjp = jax.vjp(fj, jnp.asarray(x["cg"]),
                                   jnp.asarray(x["cc"]), col_j)
    dcg_j, dcc_j, dcol_j = vjp((jnp.asarray(x["dD"]), jnp.asarray(x["dV"]),
                                jnp.asarray(x["dC"])))

    tg, tc = pt["geo_fine"], pt["col_fine"]
    cg_t = torch.tensor(x["cg"], requires_grad=True)
    cc_t = torch.tensor(x["cc"], requires_grad=True)
    p_t = torch.tensor(x["p"], requires_grad=True)
    geo_t = [w.requires_grad_() for w in tFM.flatten_core(tg["core"])]
    col_t = [w.requires_grad_() for w in tFM.flatten_core(tc["core"])]
    d_t, v_t, c_t = tFM.nicer_fused_composite(
        cg_t, cc_t, p_t, torch.tensor(x["z"]), torch.tensor(x["pm"]), geo_t,
        col_t, (tg["B"], tc["B"]), cfg.n_blocks, cfg.skip, with_color, S,
        COEF, need_wgrads, sigmoid_rgb)
    torch.autograd.backward([d_t, v_t, c_t], [torch.tensor(x["dD"]),
                                              torch.tensor(x["dV"]),
                                              torch.tensor(x["dC"])])
    _close(d_t.detach(), d_j, "depth")
    _close(v_t.detach(), v_j, "var", VAR_RTOL, VAR_ATOL)
    _close(c_t.detach(), c_j, "color")
    _close(cg_t.grad, dcg_j, "dc_geo")
    # frozen inputs get no gradient, as in the reference
    assert p_t.grad is None and all(w.grad is None for w in geo_t)
    if not with_color:
        assert not c_t.any() and cc_t.grad is None
        assert all(w.grad is None for w in col_t)
        return
    _close(cc_t.grad, dcc_j, "dc_col")
    for i, (a, b) in enumerate(zip(col_t, dcol_j)):
        if need_wgrads:
            _close(a.grad, b, f"dcol[{i}]")
        else:
            assert a.grad is None and not np.asarray(b).any()


@pytest.mark.parametrize("with_color,sigmoid_rgb,need_wgrads", CASES,
                         ids=IDS)
def test_fused_comp_bwd_matches_pallas_reference(rng, with_color,
                                                 sigmoid_rgb, need_wgrads):
    """Kernel #7's plain version (what fused_comp_bwd runs on the CPU)
    against the reference's `_fused_comp_bwd`, the Pallas backward in
    interpret mode."""
    cfg, pj, pt, S, x = _setup(rng)
    gd, cd = pj["geo_fine"], pj["col_fine"]
    dcg_j, dcc_j, dcol_j = jFM._fused_comp_bwd(
        jnp.asarray(x["p"]), jnp.asarray(x["cg"]), jnp.asarray(x["cc"]),
        jnp.asarray(x["z"]), jnp.asarray(x["pm"]), gd["B"], cd["B"],
        tuple(jFM.flatten_core(gd["core"])),
        tuple(jFM.flatten_core(cd["core"])), jnp.asarray(x["dD"]),
        jnp.asarray(x["dV"]), jnp.asarray(x["dC"]), n_blocks=cfg.n_blocks,
        skip=cfg.skip, with_color=with_color, S=S, coef=COEF,
        need_wgrads=need_wgrads, sigmoid_rgb=sigmoid_rgb)
    tg, tc = pt["geo_fine"], pt["col_fine"]
    T = torch.tensor
    dcg_t, dcc_t, dcol_t = tFM.fused_comp_bwd(
        T(x["p"]), T(x["cg"]), T(x["cc"]), T(x["z"]), T(x["pm"]),
        (tg["B"], tc["B"]), tFM.flatten_core(tg["core"]),
        tFM.flatten_core(tc["core"]), T(x["dD"]), T(x["dV"]), T(x["dC"]),
        cfg.n_blocks, cfg.skip, with_color, S, COEF, need_wgrads,
        sigmoid_rgb)
    _close(dcg_t, dcg_j, "dc_geo")
    _close(dcc_t, dcc_j, "dc_col")
    for i, (a, b) in enumerate(zip(dcol_t, dcol_j)):
        _close(a, b, f"dcol[{i}]")


@pytest.mark.parametrize("sigmoid_rgb", [True, False],
                         ids=["sigmoid", "raw"])
def test_composite_backward_matches_autograd(rng, sigmoid_rgb):
    """nicer_fused_composite's written-out backward (comp_cotangents, then
    the trunk backward) against autograd through composite_plain, in
    float64, so that the comparison is of the formulas and not of f32
    rounding: rtol 1e-9 / atol 1e-10."""
    cfg, _pj, pt, S, x = _setup(rng)
    tg, tc = pt["geo_fine"], pt["col_fine"]
    D = torch.float64

    def t(a):
        return torch.tensor(a, dtype=D)
    geo = [w.to(D) for w in tFM.flatten_core(tg["core"])]
    Bs = (tg["B"].to(D), tc["B"].to(D))
    grads = []
    for fn in ("wrapper", "autograd"):
        cg, cc = t(x["cg"]).requires_grad_(), t(x["cc"]).requires_grad_()
        col = [w.to(D).requires_grad_() for w in tFM.flatten_core(
            tc["core"])]
        args = (t(x["p"]), t(x["z"]), t(x["pm"]))
        if fn == "wrapper":
            out = tFM.nicer_fused_composite(cg, cc, *args, geo, col, Bs,
                                            cfg.n_blocks, cfg.skip, True, S,
                                            COEF, True, sigmoid_rgb)
        else:
            out = tFM.composite_plain(args[0], cg, cc, args[1], args[2], Bs,
                                      geo, col, cfg.n_blocks, cfg.skip,
                                      True, S, COEF, sigmoid_rgb)[:3]
        torch.autograd.backward(list(out), [t(x["dD"]), t(x["dV"]),
                                            t(x["dC"])])
        grads.append([cg.grad, cc.grad] + [w.grad for w in col])
    for i, (a, b) in enumerate(zip(*grads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-10, err_msg=f"grad {i}")
