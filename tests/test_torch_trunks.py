"""Fused decoder trunks of the PyTorch port (plain forward and the backward
written out as the reference writes it) against hpslam_tpu's
nicer_fused_color / nicer_fused_geo, whose Pallas kernels run in interpret
mode on the CPU.  Same inputs and output cotangents through both; forward
values, dp, dc_geo, dc_col and the colour-core weight grads compared.  Also
decoder.fused_color_pair and eval_stage's fused branches against the
reference's.

Tolerance: rtol 2e-4 / atol 1e-4 on f32.  The two sides order the trunk
matmul sums and the Fourier projection differently, and the projection
reaches ~1e3 rad at these positions (|p| ~ 1, |B| ~ 25), where one f32 ulp
is 6e-5 rad: each side is up to ~5e-5 from a float64 evaluation of the same
function.  dp is scaled by 2 pi B, so its atol is 1e-4 times 2 pi 25.
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
from hpslam_tpu_torch.models import decoder as tDec
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


def small_cfg(**kw):
    return jDec.ModelConfig(c_dim=8, geo_embed=16, col_embed=8, rel_embed=4,
                            hidden_geo=16, hidden_col=32, **kw)


def _setup(rng, n=64):
    cfg = small_cfg()
    pj = jDec.init_nicer(jax.random.PRNGKey(4), cfg)
    pt = convert.params_from_numpy(jax.tree.map(np.asarray, pj))
    p = rng.normal(0, 0.6, (n, 3)).astype(np.float32)
    cg = rng.normal(0, 0.3, (n, cfg.c_dim)).astype(np.float32)
    cc = rng.normal(0, 0.3, (n, cfg.c_dim)).astype(np.float32)
    g_occ = rng.normal(size=(n,)).astype(np.float32)
    g_rgb = rng.normal(size=(n, 3)).astype(np.float32)
    return cfg, pj, pt, p, cg, cc, g_occ, g_rgb


def _close(a, b, name, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("with_color,need_dp",
                         [(True, True), (True, False), (False, True)],
                         ids=["color+dp", "color", "geometry+dp"])
def test_fused_trunks_match_pallas_reference(rng, with_color, need_dp):
    cfg, pj, pt, p, cg, cc, g_occ, g_rgb = _setup(rng)
    gd, cd = pj["geo_fine"], pj["col_fine"]
    geo_j = tuple(jFM.flatten_core(gd["core"]))
    col_j = tuple(jFM.flatten_core(cd["core"]))
    if with_color:
        def fj(p_, cg_, cc_, col_):
            return jFM.nicer_fused_color(p_, cg_, cc_, geo_j, col_, (
                gd["B"], cd["B"]), cfg.n_blocks, cfg.skip, False, need_dp,
                True)
        out_j, vjp = jax.vjp(fj, jnp.asarray(p), jnp.asarray(cg),
                             jnp.asarray(cc), col_j)
        occ_j, rgb_j = out_j
        dp_j, dcg_j, dcc_j, dcol_j = vjp((jnp.asarray(g_occ),
                                          jnp.asarray(g_rgb)))
    else:
        def fj(p_, cg_):
            return jFM.nicer_fused_geo(p_, cg_, geo_j, gd["B"], cfg.n_blocks,
                                       cfg.skip, False, need_dp)
        occ_j, vjp = jax.vjp(fj, jnp.asarray(p), jnp.asarray(cg))
        dp_j, dcg_j = vjp(jnp.asarray(g_occ))

    tg, tc = pt["geo_fine"], pt["col_fine"]
    p_t = torch.tensor(p, requires_grad=True)
    cg_t = torch.tensor(cg, requires_grad=True)
    cc_t = torch.tensor(cc, requires_grad=True)
    geo_t = [w.requires_grad_() for w in tFM.flatten_core(tg["core"])]
    col_t = [w.requires_grad_() for w in tFM.flatten_core(tc["core"])]
    Bs = (tg["B"].requires_grad_(), tc["B"].requires_grad_())
    if with_color:
        occ_t, rgb_t = tFM.nicer_fused_color(p_t, cg_t, cc_t, geo_t, col_t,
                                             Bs, cfg.n_blocks, cfg.skip,
                                             need_dp=need_dp)
        torch.autograd.backward([occ_t, rgb_t], [torch.tensor(g_occ),
                                                 torch.tensor(g_rgb)])
        _close(rgb_t.detach(), rgb_j, "rgb")
    else:
        occ_t = tFM.nicer_fused_geo(p_t, cg_t, geo_t, Bs[0], cfg.n_blocks,
                                    cfg.skip, need_dp=need_dp)
        occ_t.backward(torch.tensor(g_occ))
    _close(occ_t.detach(), occ_j, "occ")
    _close(p_t.grad, dp_j, "dp", atol=ATOL * 2 * np.pi * 25)
    if not need_dp:
        assert not p_t.grad.any()
    _close(cg_t.grad, dcg_j, "dc_geo")
    if with_color:
        _close(cc_t.grad, dcc_j, "dc_col")
        for i, (a, b) in enumerate(zip(col_t, dcol_j)):
            _close(a.grad, b, f"dcol[{i}]")
    # frozen inputs: the geometry core and both Bs get no gradient (zero)
    assert all(w.grad is None for w in geo_t)
    assert Bs[0].grad is None and Bs[1].grad is None


def test_fused_trunks_need_wgrads_off(rng):
    """need_wgrads=False leaves the colour core without a gradient (zero)
    and the other cotangents as they were."""
    cfg, _pj, pt, p, cg, cc, g_occ, g_rgb = _setup(rng, n=24)
    tg, tc = pt["geo_fine"], pt["col_fine"]
    outs = []
    for need_wgrads in (True, False):
        cg_t = torch.tensor(cg, requires_grad=True)
        col_t = [w.clone().requires_grad_()
                 for w in tFM.flatten_core(tc["core"])]
        occ, rgb = tFM.nicer_fused_color(
            torch.tensor(p), cg_t, torch.tensor(cc),
            tFM.flatten_core(tg["core"]), col_t, (tg["B"], tc["B"]),
            cfg.n_blocks, cfg.skip, need_dp=False, need_wgrads=need_wgrads)
        torch.autograd.backward([occ, rgb], [torch.tensor(g_occ),
                                             torch.tensor(g_rgb)])
        outs.append((cg_t.grad, [w.grad for w in col_t]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(g is not None and g.any() for g in outs[0][1][::2])
    assert all(g is None for g in outs[1][1])


@pytest.mark.parametrize("expo", [False, True], ids=["sigmoid", "exposure"])
def test_fused_color_pair_matches_reference(rng, expo):
    cfg, pj, pt, p, cg, cc, _g, _r = _setup(rng, n=32)
    cfg = dataclasses.replace(cfg, encode_exposure=expo, fused_mlp=True)
    if expo:
        pj = jDec.init_nicer(jax.random.PRNGKey(4), cfg)
        pt = convert.params_from_numpy(jax.tree.map(np.asarray, pj))
    ef = rng.normal(size=(cfg.exposure_dim,)).astype(np.float32)
    tcfg = tDec.ModelConfig(**dataclasses.asdict(cfg))
    occ_j, rgb_j = jDec.fused_color_pair(
        pj["geo_fine"], pj["col_fine"], cfg, jnp.asarray(p), jnp.asarray(cg),
        jnp.asarray(cc), exposure_feat=jnp.asarray(ef) if expo else None)
    occ_t, rgb_t = tDec.fused_color_pair(
        pt["geo_fine"], pt["col_fine"], tcfg, torch.tensor(p),
        torch.tensor(cg), torch.tensor(cc),
        exposure_feat=torch.tensor(ef) if expo else None)
    _close(occ_t.detach(), occ_j, "occ")
    _close(rgb_t.detach(), rgb_j, "rgb")


@pytest.mark.parametrize("stage", ["geometry_fine", "color_fine"])
def test_eval_stage_fused_branch_matches_reference(rng, stage):
    """eval_stage with fused_mlp on (mapper mode: weights from the search
    distances) against the reference's, which runs its Pallas trunks."""
    from hpslam_tpu.ops import knn as jK
    cfg = small_cfg(fused_mlp=True)
    pj = jDec.init_nicer(jax.random.PRNGKey(6), cfg)
    pt = convert.params_from_numpy(jax.tree.map(np.asarray, pj))
    n_rays, S, C = 8, 5, cfg.c_dim
    cloud = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    geo = rng.normal(0, 0.3, (300, C)).astype(np.float32)
    col = rng.normal(0, 0.3, (300, C)).astype(np.float32)
    p = rng.uniform(-0.8, 0.8, (n_rays * S, 3)).astype(np.float32)
    rq = np.full((n_rays * S,), 0.5, np.float32)
    D, I = jK.knn(jnp.asarray(p), jnp.asarray(cloud), jnp.int32(300), k=8)
    raw_j, vm_j, has_j = jDec.eval_stage(
        pj, cfg, stage, jnp.asarray(p), D, I, jnp.asarray(geo),
        jnp.asarray(col), jnp.asarray(cloud), jnp.asarray(rq), S)
    tcfg = tDec.ModelConfig(**dataclasses.asdict(cfg))
    raw_t, vm_t, has_t = tDec.eval_stage(
        pt, tcfg, stage, torch.tensor(p), torch.tensor(np.asarray(D)),
        torch.tensor(np.asarray(I)).long(), torch.tensor(geo),
        torch.tensor(col), torch.tensor(cloud), torch.tensor(rq), S)
    np.testing.assert_array_equal(has_t.numpy(), np.asarray(has_j))
    np.testing.assert_array_equal(vm_t.numpy(), np.asarray(vm_j))
    _close(raw_t.detach(), raw_j, "raw")
