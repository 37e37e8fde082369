"""Decoders of the PyTorch port against hpslam_tpu, from identical weights
(carried across by hpslam_tpu_torch.convert).  float32 both sides; the
Fourier projection reaches ~1e2 rad at these scales, so embeddings (and
what follows) agree to ~1e-5 relative rather than to the last ulp."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpslam_tpu.models import decoder as jDec
from hpslam_tpu_torch import convert
from hpslam_tpu_torch.models import decoder as tDec


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two torch threads per test: the suite runs in several processes at
    once, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cfg(**kw):
    return jDec.ModelConfig(c_dim=8, geo_embed=16, col_embed=8, rel_embed=4,
                            hidden_geo=16, hidden_col=32, **kw)


def t_cfg(jcfg):
    return tDec.ModelConfig(**dataclasses.asdict(jcfg))


def params_pair(cfg, seed=0):
    pj = jDec.init_nicer(jax.random.PRNGKey(seed), cfg)
    pn = jax.tree.map(np.asarray, pj)
    return pj, convert.params_from_numpy(pn)


def test_convert_round_trip():
    cfg = small_cfg(encode_exposure=True)
    pj, pt = params_pair(cfg)
    back = convert.params_to_numpy(pt)
    flat_j = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, pj))
    assert len(flat_j) == len(jax.tree.leaves(back))
    for path, a in flat_j:
        b = back
        for key in path:
            b = b[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_array_equal(a, b)
    # shapes and layout of a converted core match the reference's tree
    assert pt["col_fine"]["core"]["layers"][3]["w"].shape == (32 + 16, 32)
    assert pt["geo_mid"]["core"]["out"]["w"].shape == (16, 1)


@pytest.mark.parametrize("expo", [False, True])
def test_apply_geo_color_exposure(rng, expo):
    cfg = small_cfg(encode_exposure=expo)
    pj, pt = params_pair(cfg, seed=1)
    n = 64
    p = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    cg = rng.normal(0, 0.3, (n, 8)).astype(np.float32)
    cc = rng.normal(0, 0.3, (n, 8)).astype(np.float32)
    ef = rng.normal(0, 0.1, (8,)).astype(np.float32)
    occ_j = jDec.apply_geo(pj["geo_fine"], cfg, jnp.asarray(p),
                           jnp.asarray(cg))
    occ_t = tDec.apply_geo(pt["geo_fine"], t_cfg(cfg), torch.tensor(p),
                           torch.tensor(cg))
    np.testing.assert_allclose(occ_t.numpy(), np.asarray(occ_j), rtol=1e-4,
                               atol=1e-4)
    kw_j = {"exposure_feat": jnp.asarray(ef)} if expo else {}
    kw_t = {"exposure_feat": torch.tensor(ef)} if expo else {}
    rgb_j = jDec.apply_color(pj["col_fine"], cfg, jnp.asarray(p),
                             jnp.asarray(cc), **kw_j)
    rgb_t = tDec.apply_color(pt["col_fine"], t_cfg(cfg), torch.tensor(p),
                             torch.tensor(cc), **kw_t)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-4,
                               atol=1e-5)
    if expo:
        rj, tj = jDec.exposure_affine(pj["col_fine"], jnp.asarray(ef))
        rt, tt = tDec.exposure_affine(pt["col_fine"], torch.tensor(ef))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-5,
                                   atol=1e-7)


def test_softplus_and_valid_ray_mask(rng):
    x = np.concatenate([np.linspace(-1, 1, 101),
                        [0.19999, 0.2, 0.20001]]).astype(np.float32)
    np.testing.assert_allclose(
        tDec.softplus100(torch.tensor(x)).numpy(),
        np.asarray(jDec.softplus100(jnp.asarray(x))), rtol=1e-6, atol=1e-9)
    has = rng.uniform(size=(40,)) > 0.4
    np.testing.assert_array_equal(
        tDec.valid_ray_mask(torch.tensor(has), 5, 5).numpy(),
        np.asarray(jDec.valid_ray_mask(jnp.asarray(has), 5, 5)))


def test_eval_stage_fused_trunks_match_plain(rng):
    """The fused trunks are ported: eval_stage with fused_mlp on gives what
    the plain trunks give, in values and in the gradients of the features
    and of the colour core (rtol 1e-5 / atol 1e-6: the same f32 products,
    summed in another grouping by the written-out backward)."""
    cfg = tDec.ModelConfig(c_dim=8, geo_embed=16, col_embed=8, rel_embed=4,
                           hidden_geo=16, hidden_col=32)
    params = tDec.init_nicer(torch.Generator().manual_seed(3), cfg, "cpu")
    n, k = 40, 8
    cloud = torch.tensor(rng.uniform(-1, 1, (200, 3)).astype(np.float32))
    p = torch.tensor(rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32))
    D, I = torch.topk(torch.cdist(p, cloud) ** 2, k, dim=1, largest=False)
    rq = torch.full((n,), 0.6)
    geo = torch.tensor(rng.normal(0, 0.3, (200, 8)).astype(np.float32))
    col = torch.tensor(rng.normal(0, 0.3, (200, 8)).astype(np.float32))
    w_out = params["col_fine"]["core"]["out"]["w"]
    for stage in ("geometry_fine", "color_fine"):
        outs = []
        for fused in (False, True):
            c = dataclasses.replace(cfg, fused_mlp=fused)
            assert tDec.fused_usable(c) == fused
            feats = [geo.clone().requires_grad_(),
                     col.clone().requires_grad_()]
            w_out.grad = None
            w_out.requires_grad_(True)
            raw, _vm, _has = tDec.eval_stage(params, c, stage, p, D, I,
                                             *feats, cloud, rq, 5)
            raw.sum().backward()
            w_out.requires_grad_(False)
            grads = [f.grad if f.grad is not None else torch.zeros_like(f)
                     for f in feats]
            wg = (w_out.grad if w_out.grad is not None
                  else torch.zeros_like(w_out))
            outs.append([raw.detach()] + grads + [wg])
        for name, a, b in zip(("raw", "dgeo", "dcol", "dWout"), *outs):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{stage} {name}")


@pytest.mark.parametrize("trunk", ["geo", "col"])
def test_mlp_trunk_mm_bf16_matches_reference(rng, trunk):
    """model.mm_bf16's trunk (bf16 operands, f32 accumulation and bias,
    f32 activation, bf16 block outputs and skip concat) against the
    reference's _mlp_trunk: forward and the gradients in the embedding,
    the feature and every weight, at the reference's own bf16 tolerance
    (tests/test_engines.py: 1e-2).  Both round the same operands to bf16;
    the sums run in another order and the backward's bf16 casts sit where
    JAX's transpose rules put them, so outputs differ by bf16 ulps."""
    cfg = small_cfg(mm_bf16=True)
    pj, pt = params_pair(cfg, seed=3)
    name = f"{trunk}_fine"
    core_j, core_t = pj[name]["core"], pt[name]["core"]
    emb_w = core_j["layers"][0]["w"].shape[0]
    n = 96
    e = rng.normal(0, 1.0, (n, emb_w)).astype(np.float32)
    c = rng.normal(0, 0.3, (n, 8)).astype(np.float32)
    g = rng.normal(size=(n, core_j["out"]["w"].shape[1])).astype(np.float32)
    act_j = jax.nn.relu if trunk == "geo" else jDec.softplus100
    act_t = torch.relu if trunk == "geo" else tDec.softplus100

    def fj(core, e_, c_):
        out = jDec._mlp_trunk(core, cfg, e_, c_, act_j)
        return jnp.sum(out * g), out

    (_, out_j), grads_j = jax.value_and_grad(fj, argnums=(0, 1, 2),
                                             has_aux=True)(
        core_j, jnp.asarray(e), jnp.asarray(c))
    leaves_t = [t.requires_grad_() for t in jax.tree.leaves(core_t)]
    e_t = torch.tensor(e, requires_grad=True)
    c_t = torch.tensor(c, requires_grad=True)
    out_t = tDec.mlp_trunk(core_t, t_cfg(cfg), e_t, c_t, act_t)
    assert out_t.dtype == torch.float32
    torch.sum(out_t * torch.tensor(g)).backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-2, atol=1e-2)
    gj = jax.tree.leaves(grads_j[0]) + [grads_j[1], grads_j[2]]
    gt = [t.grad for t in leaves_t] + [e_t.grad, c_t.grad]
    assert len(gj) == len(gt)
    for a, b in zip(gt, gj):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-2,
                                   atol=1e-2 * max(1.0, np.abs(b).max()))
