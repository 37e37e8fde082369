"""The per-sample mapping path of the port (rel-pos colour, bundle
adjustment) against hpslam_tpu on the CPU, at small widths.

* ``interpolate_level_feats`` with ``encode_rel_pos``: forward and the
  gradients of features, positions and the neighbour MLP match the
  reference (rtol 1e-4 / atol 1e-5); the feature gradient goes through
  ``index_add_rows`` and equals ``index_add_``'s bit for bit on the CPU.
* ``render_rays`` with rel-pos colour, mapper and tracker mode: depth,
  colour and the gradients of features (rtol 1e-4 / atol 1e-5, f32 sums
  ordered differently) and of the ray origins (tracker mode: relative
  Frobenius 1e-4, as the distance weights amplify f32 rounding).
* ``build_pixel_knn_cache`` given the reference's pixel ids: D within
  1e-6, I equal where no two distances tie.
* One per-sample mapping iteration (``samples_stage_loss``) on identical
  parameters, cache and sampled slots: loss and the gradients of the
  feature tables, the colour decoder, the exposure latent and, under BA,
  the camera tensors (rtol 2e-4 / atol 2e-5 relative to each tensor's
  largest entry).  The BA case runs the port's fused trunks (their plain
  version here) against the reference's plain trunks.
* The reference's BA tests (tests/test_engines.py, slow there): BA moves
  the trainable poses and leaves the frozen slots bit for bit; BA on the
  fused trunks gives a trainable colour decoder real weight gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpslam_tpu import mapper as jM
from hpslam_tpu import renderer as jR
from hpslam_tpu.models import decoder as jDec
from hpslam_tpu.ops import geometry as jG
from hpslam_tpu.ops import knn as jK
from tests import test_engines as jte
from hpslam_tpu_torch import convert
from hpslam_tpu_torch import mapper as tM
from hpslam_tpu_torch import renderer as tR
from hpslam_tpu_torch.models import decoder as tDec
from hpslam_tpu_torch.ops import geometry as tG
from hpslam_tpu_torch.ops import interpolate as tIT
from hpslam_tpu_torch.ops import knn as tK
from hpslam_tpu_torch.ops import optim as tOpt

RTOL, ATOL = 1e-4, 1e-5
FRO_RTOL = 1e-4


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


def t_cfg(jcfg, **kw):
    return tDec.ModelConfig(**dict(dataclasses.asdict(jcfg), **kw))


def params_pair(jcfg, seed=0):
    pj = jDec.init_nicer(jax.random.PRNGKey(seed), jcfg)
    return pj, convert.params_from_numpy(jax.tree.map(np.asarray, pj))


def T(x, grad=False):
    t = torch.tensor(np.asarray(x))
    return t.requires_grad_() if grad else t


def close(a, b, rtol=RTOL, atol=ATOL, scale=False):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    if scale:
        atol = atol * max(float(np.abs(b).max()), 1e-12)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def corner_scene(rng, n=40):
    pos, count, geo, col = jte.corner_level(rng)
    dirs = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.5, 0.5, n),
                     -np.ones(n)], -1).astype(np.float32)
    d_gt = jte.corner_depth(dirs).astype(np.float32)
    return (np.asarray(pos), int(count), np.asarray(geo), np.asarray(col),
            dirs, d_gt)


@pytest.mark.parametrize("diff_pos", [False, True])
def test_interpolate_rel_pos_matches_reference(rng, diff_pos):
    jcfg = small_cfg(encode_rel_pos_in_col=True)
    pj, pt = params_pair(jcfg)
    pos, count, _geo, col, dirs, d_gt = corner_scene(rng)
    z = np.linspace(0.96, 1.04, 5)[None, :] * d_gt[:, None]
    p = (dirs[:, None] * z[..., None]).reshape(-1, 3).astype(np.float32)
    D, I = jK.knn(jnp.asarray(p), jnp.asarray(pos), jnp.int32(count), k=8)
    rq = np.full((p.shape[0],), 0.3, np.float32)

    def f_j(feats, pp, dec):
        c, has = jDec.interpolate_level_feats(
            dec, jcfg, pp, D, I, feats, jnp.asarray(pos), jnp.asarray(rq),
            diff_pos, True)
        return jnp.sum(jnp.sin(3.0 * c)), (c, has)

    (lj, (cj, hj)), gj = jax.value_and_grad(f_j, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(col), jnp.asarray(p), pj["col_fine"])
    feats_t, p_t = T(col, True), T(p, True)
    dec_t = tOpt.tree_map(lambda x: x.clone().requires_grad_(),
                          pt["col_fine"])
    calls = []
    real = tIT.index_add_rows

    def spy(rows, idx, src):
        calls.append((rows, idx, src.detach().clone()))
        return real(rows, idx, src)

    tIT.index_add_rows = spy
    try:
        ct, ht = tDec.interpolate_level_feats(
            dec_t, t_cfg(jcfg), p_t, T(D), T(I).long(), feats_t, T(pos),
            T(rq), diff_pos, True)
        lt = torch.sum(torch.sin(3.0 * ct))
        g_feats, g_p, g_rel, g_l1 = torch.autograd.grad(
            lt, [feats_t, p_t, dec_t["rel_B"],
                 dec_t["mlp_neighbor"]["l1"]["w"]])
    finally:
        tIT.index_add_rows = real
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    close(ct, cj)
    close(lt, lj)
    close(g_feats, gj[0], scale=True)
    close(g_p, gj[1], scale=True)
    close(g_rel, gj[2]["rel_B"], scale=True)
    close(g_l1, gj[2]["mlp_neighbor"]["l1"]["w"], scale=True)
    # the feature gradient is index_add_rows' scatter of the gathered
    # rows' cotangents: on the CPU exactly index_add_
    assert len(calls) == 1 and calls[0][0] == col.shape[0]
    _, idx, src = calls[0]
    ref = torch.zeros_like(feats_t).index_add_(0, idx, src)
    assert torch.equal(g_feats, ref)


@pytest.mark.parametrize("stage,tracker", [("color_fine", False),
                                           ("color_mid", True),
                                           ("geometry_fine", True)])
def test_render_rays_rel_pos_matches_reference(rng, stage, tracker):
    jcfg = small_cfg(encode_rel_pos_in_col=True)
    pj, pt = params_pair(jcfg, seed=3)
    rcfg_j = jR.RenderConfig(sample_near_pcl=False, near_end_surface=0.96,
                             far_end_surface=1.04)
    rcfg_t = tR.RenderConfig(**dataclasses.asdict(rcfg_j))
    pos, count, geo, col, dirs, d_gt = corner_scene(rng)
    ro = np.zeros_like(dirs)
    rq = np.full((dirs.shape[0],), 0.3, np.float32)
    z = np.asarray(jR.S.surface_z_vals(jnp.asarray(d_gt), 5, 0.96, 1.04))
    p = (ro[:, None] + dirs[:, None] * z[..., None]).reshape(-1, 3)
    D, I = jK.knn(jnp.asarray(p), jnp.asarray(pos), jnp.int32(count), k=8)

    def f_j(geo_, col_, ro_):
        d, u, c, v = jR.render_rays(
            pj, jcfg, rcfg_j, stage, ro_, jnp.asarray(dirs),
            jnp.asarray(d_gt), jnp.asarray(pos), jnp.int32(count), geo_,
            col_, jnp.asarray(rq), is_tracker=tracker, knn_cache=(D, I))
        return jnp.sum(d) + jnp.sum(jnp.cos(c)), (d, c, v)

    (lj, (dj, cj, vj)), gj = jax.value_and_grad(
        f_j, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(geo), jnp.asarray(col), jnp.asarray(ro))
    geo_t, col_t, ro_t = T(geo, True), T(col, True), T(ro, True)
    dt, _u, ct, vt = tR.render_rays(
        pt, t_cfg(jcfg), rcfg_t, stage, ro_t, T(dirs), T(d_gt), T(pos),
        count, geo_t, col_t, T(rq), is_tracker=tracker,
        knn_cache=(T(D), T(I).long()))
    lt = torch.sum(dt) + torch.sum(torch.cos(ct))
    grads = torch.autograd.grad(lt, [geo_t, col_t, ro_t], allow_unused=True)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    close(dt, dj)
    close(ct, cj)
    for name, g, r in zip(("geo", "col", "rays_o"), grads, gj):
        if g is None:
            assert not np.asarray(r).any()
        elif name == "rays_o" and tracker:
            # through the distance weights 1/(d^2 + 1e-10), whose square
            # amplifies f32 rounding: held in relative Frobenius norm
            r = np.asarray(r)
            assert (np.linalg.norm(g.numpy() - r) / np.linalg.norm(r)
                    < FRO_RTOL)
        else:
            close(g, r, scale=True)


# ---------------------------------------------------------------------------
# the per-sample mapping iteration

FX = FY = 20.0
CX, CY = 15.5, 11.5
HH, WW = 24, 32


def wall_window(rng, F=3):
    """The reference's wall fixture (tests/test_engines.py) seen by F
    window frames, the second one moved a little."""
    pos, count, geo, col = jte.wall_level(rng)
    jj, ii = np.mgrid[0:HH, 0:WW]
    dirs = np.stack([(ii - CX) / FX, -(jj - CY) / FY,
                     -np.ones_like(ii, float)], -1)
    depth = (2.0 / -dirs[..., 2]).astype(np.float32)
    colors = np.broadcast_to(rng.uniform(0.2, 0.8, (HH, WW, 3)).astype(
        np.float32), (F, HH, WW, 3)).copy()
    depths = np.broadcast_to(depth, (F, HH, WW)).copy()
    c2ws = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    c2ws[1, 0, 3] = 0.03
    rq = np.full((F, HH, WW), 0.4, np.float32)
    pools = np.broadcast_to(np.arange(HH * WW, dtype=np.int32),
                            (F, HH * WW)).copy()
    pool_lens = np.full((F,), HH * WW, np.int32)
    return dict(pos=np.asarray(pos), count=int(count), geo=np.asarray(geo),
                col=np.asarray(col), colors=colors, depths=depths, c2ws=c2ws,
                rq=rq, pools=pools, pool_lens=pool_lens)


def reference_cache(w, P=64, key=7):
    """build_pixel_knn_cache of the reference (the wall's 13 tiles are
    fewer than the 16 probed, so the search is exact)."""
    return jM.build_pixel_knn_cache(
        jax.random.PRNGKey(key), jnp.asarray(w["depths"]),
        jnp.asarray(w["c2ws"]), jnp.asarray(w["pools"]),
        jnp.asarray(w["pool_lens"]),
        jK.build_tiles(jnp.asarray(w["pos"]), jnp.int32(w["count"])),
        P=P, S=5, k=8, H=HH, W=WW, fx=FX, fy=FY, cx=CX, cy=CY,
        near_surface=0.96, far_surface=1.04)


def test_build_pixel_knn_cache_matches_reference(rng):
    w = wall_window(rng)
    pix, Dj, Ij = (np.asarray(a) for a in reference_cache(w))
    _pix, Dt, It = tM.build_pixel_knn_cache(
        None, T(w["depths"]), T(w["c2ws"]), None, None,
        tK.build_tiles(T(w["pos"]), w["count"]), P=64, S=5, k=8, W=WW,
        fx=FX, fy=FY, cx=CX, cy=CY, near_surface=0.96, far_surface=1.04,
        idx=T(pix).long())
    assert Dt.shape == Dj.shape == (3, 64, 5, 8)
    np.testing.assert_allclose(Dt.numpy(), Dj, rtol=0, atol=1e-6)
    Ds = np.sort(Dj, -1)
    tie = np.zeros(Dj.shape, bool)
    tie[..., 1:] |= np.abs(np.diff(Ds, axis=-1)) < 1e-6
    tie[..., :-1] |= np.abs(np.diff(Ds, axis=-1)) < 1e-6
    assert tie.mean() < 0.2
    np.testing.assert_array_equal(It.numpy()[~tie], Ij[~tie])
    # the drawn pixels lie in each frame's pool, all frames searched
    idx, D2, I2 = tM.build_pixel_knn_cache(
        torch.Generator().manual_seed(0), T(w["depths"]), T(w["c2ws"]),
        T(w["pools"]).long(), T(w["pool_lens"]).long(),
        tK.build_tiles(T(w["pos"]), w["count"]), P=64, S=5, k=8, W=WW,
        fx=FX, fy=FY, cx=CX, cy=CY, near_surface=0.96, far_surface=1.04)
    assert idx.shape == (3, 64) and int(idx.max()) < HH * WW
    assert D2.shape == I2.shape == (3, 64, 5, 8) and bool((D2 < 1).all())


def _inside_thresh(cache_pix, depths, F_actual):
    d = depths[np.arange(depths.shape[0])[:, None], cache_pix // WW,
               cache_pix % WW]
    sd = np.sort(np.where(np.arange(depths.shape[0])[:, None] < F_actual,
                          d, np.inf).reshape(-1))
    n = F_actual * cache_pix.shape[1]
    return min(10.0 * sd[(n - 1) // 2], 1.2 * sd[n - 1])


def reference_iteration(pj, jcfg, rcfg, w, cache, op, fid, slot, stage,
                        use_ba, trainable, use_exposure, w_color):
    """The reference's per-sample stage loss (hpslam_tpu/mapper.py
    map_scan, non-union branch), written out on the reference's parts."""
    cache_pix, cacheD, cacheI = cache
    thresh = _inside_thresh(np.asarray(cache_pix), w["depths"], 3)
    pr = dict(pj)
    if stage.startswith("color") and "dec" in op:
        pr.update(op["dec"])
    idx = cache_pix[fid, slot]
    jj, ii = idx // WW, idx % WW
    if use_ba:
        cams = jnp.where(trainable[:, None], op["cams"],
                         jax.lax.stop_gradient(op["cams"]))
        poses = jG.get_camera_from_tensor(cams)
    else:
        poses = jnp.asarray(w["c2ws"])[:, :3, :]
    dirs = jnp.stack([(ii.astype(jnp.float32) - CX) / FX,
                      -(jj.astype(jnp.float32) - CY) / FY,
                      -jnp.ones(ii.shape)], -1)
    rays_d = jnp.einsum("nd,nkd->nk", dirs, poses[fid, :3, :3],
                        precision=jax.lax.Precision.HIGHEST)
    rays_o = poses[fid, :3, 3]
    d_gt = jnp.asarray(w["depths"])[fid, jj, ii]
    c_gt = jnp.asarray(w["colors"])[fid, jj, ii]
    rq = jnp.asarray(w["rq"])[fid, jj, ii]
    kc = (cacheD[fid, slot].reshape(-1, 8), cacheI[fid, slot].reshape(-1, 8))
    depth, _u, color, vmask = jR.render_rays(
        pr, jcfg, rcfg, stage, rays_o, rays_d, d_gt, jnp.asarray(w["pos"]),
        jnp.int32(w["count"]), op["geo"], op["col"], rq, is_tracker=use_ba,
        knn_cache=kc)
    mask = (d_gt > 0) & vmask & jnp.isfinite(depth) & (d_gt <= thresh)
    gl = jnp.sum(jnp.where(mask, jnp.abs(d_gt - depth), 0.0))
    if stage.startswith("geometry"):
        return gl
    if use_exposure:
        dec = pr["col_fine"]
        ef = jnp.zeros((3, 8)).at[2].set(op["expo_feat"])
        rots, transs = jax.vmap(lambda e: jDec.exposure_affine(dec, e))(ef)
        color = jax.nn.sigmoid(
            jnp.einsum("nc,ncd->nd", color, rots[fid],
                       precision=jax.lax.Precision.HIGHEST) + transs[fid])
    return gl + w_color * jnp.sum(jnp.where(mask[:, None],
                                            jnp.abs(c_gt - color), 0.0))


CASES = {
    # rel-pos colour: the mapper-mode per-sample path
    "relpos_color": dict(kw=dict(encode_rel_pos_in_col=True),
                         stage="color_fine", ba=False, expo=True),
    "relpos_geometry": dict(kw=dict(encode_rel_pos_in_col=True),
                            stage="geometry_fine", ba=False, expo=False),
    # BA: tracker-mode rendering; the port on its fused trunks
    "ba_fused_color": dict(kw=dict(), stage="color_fine", ba=True,
                           expo=False),
    "ba_fused_geometry": dict(kw=dict(), stage="geometry_fine", ba=True,
                              expo=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_persample_iteration_matches_reference(rng, case):
    c = CASES[case]
    expo = c["expo"]
    jcfg = small_cfg(encode_exposure=expo, **c["kw"])
    tcfg = t_cfg(jcfg, fused_mlp=c["ba"])
    pj, pt = params_pair(jcfg, seed=1)
    rcfg_j = jR.RenderConfig(sample_near_pcl=False, near_end_surface=0.96,
                             far_end_surface=1.04)
    rcfg_t = tR.RenderConfig(**dataclasses.asdict(rcfg_j))
    w = wall_window(rng)
    cache = reference_cache(w)
    n = 60
    fid = np.arange(n) % 3
    slot = rng.integers(0, 64, n)
    cams = np.stack([tG.get_tensor_from_camera_np(m) for m in w["c2ws"]])
    cams[2, 5] += 0.01
    trainable = np.array([False, True, True])
    expo_feat = rng.normal(0, 0.1, 8).astype(np.float32)
    op_j = {"geo": jnp.asarray(w["geo"]), "col": jnp.asarray(w["col"]),
            "dec": {"col_fine": pj["col_fine"]}}
    if c["ba"]:
        op_j["cams"] = jnp.asarray(cams)
    if expo:
        op_j["expo_feat"] = jnp.asarray(expo_feat)

    def ref_loss(op):
        return reference_iteration(pj, jcfg, rcfg_j, w, cache, op,
                                   jnp.asarray(fid), jnp.asarray(slot),
                                   c["stage"], c["ba"],
                                   jnp.asarray(trainable), expo, 0.1)

    lj, gj = jax.value_and_grad(ref_loss)(op_j)
    op_t = convert.params_from_numpy(jax.tree.map(np.asarray, op_j))
    op_t = tOpt.tree_map(lambda x: x.requires_grad_(), op_t)
    cache_pix, cacheD, cacheI = (np.asarray(a) for a in cache)
    loss_fn = tM.samples_stage_loss(
        pt, tcfg, rcfg_t, T(w["colors"]), T(w["depths"]), T(w["c2ws"]),
        T(w["rq"]), T(cache_pix).long(), T(cacheD), T(cacheI).long(),
        torch.zeros((3, 8)), T(w["pos"]), 3, "fine", FX, FY, CX, CY, expo,
        False, 0.1, use_ba=c["ba"], cam_trainable=T(trainable))
    total, _gl, _cl = loss_fn(op_t, T(fid).long(), T(slot).long(),
                              c["stage"].startswith("color"))
    grads = torch.autograd.grad(total, tOpt.tree_leaves(op_t),
                                allow_unused=True)
    close(total, lj, rtol=2e-4)
    assert float(total.detach()) > 0
    got = named_leaves(tOpt.tree_unflatten(op_t, grads))
    want = named_leaves(gj)
    assert set(got) == set(want)
    for name, r in want.items():
        if c["ba"] and name == "dec/col_fine/B":
            # the fused trunks (both packages') freeze the Fourier B that
            # the reference's plain trunks train
            assert got[name] is None or not got[name].any()
        elif got[name] is None:
            assert not np.asarray(r).any(), name
        else:
            close(got[name], r, rtol=2e-4, atol=2e-5, scale=True)
    if c["ba"]:
        # the oldest slot is frozen; the others move
        assert not got["cams"][0].any() and got["cams"][1:].abs().max() > 0
    if c["stage"].startswith("color"):
        assert got["dec/col_fine/core/out/w"].abs().max() > 0


def named_leaves(tree, prefix=""):
    """{path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(named_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(named_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


# ---------------------------------------------------------------------------
# the reference's BA tests (tests/test_engines.py), on the port

def _ba_phase(rng, fused, opt_color_dec, n_iters, lrs):
    jcfg = small_cfg()
    tcfg = t_cfg(jcfg, fused_mlp=fused)
    _pj, pt = params_pair(jcfg)
    rcfg = tR.RenderConfig(sample_near_pcl=False, near_end_surface=0.96,
                           far_end_surface=1.04)
    w = wall_window(rng)
    depths, c2ws = T(w["depths"]), T(w["c2ws"])
    cache_pix, cD, cI = tM.build_pixel_knn_cache(
        torch.Generator().manual_seed(7), depths, c2ws, T(w["pools"]).long(),
        T(w["pool_lens"]).long(), tK.build_tiles(T(w["pos"]), w["count"]),
        P=128, S=5, k=8, W=WW, fx=FX, fy=FY, cx=CX, cy=CY,
        near_surface=0.96, far_surface=1.04)
    cams = np.stack([tG.get_tensor_from_camera_np(m) for m in w["c2ws"]])
    cams[1, 4] += 0.02              # a small error on a trainable slot
    op = {"geo": T(w["geo"]), "col": T(w["col"]), "cams": T(cams)}
    if opt_color_dec:
        op["dec"] = {"col_fine": tOpt.tree_map(torch.clone, pt["col_fine"])}
    loss_fn = tM.samples_stage_loss(
        pt, tcfg, rcfg, T(w["colors"]), depths, c2ws, T(w["rq"]), cache_pix,
        cD, cI, torch.zeros((3, 8)), T(w["pos"]), 3, "fine", FX, FY, CX, CY,
        False, False, 0.1, use_ba=True,
        cam_trainable=torch.tensor([False, True, True]))
    lr = np.tile(np.array([lrs], np.float32), (n_iters, 1))
    out, ost, losses = tM.optimise(
        loss_fn, tM.samples_lr_tree, op, tOpt.init(op),
        torch.Generator().manual_seed(1), lr, 0, 128, 128, 3)
    assert np.isfinite(losses.numpy()).all() and ost["t"] == n_iters
    return pt, cams, out


def test_map_scan_ba_updates_poses(rng):
    """BA: the camera tensors move during the BA LR window; the frozen
    (oldest) slot stays bit for bit."""
    _pt, cams, out = _ba_phase(rng, False, False, 10,
                               [0.0, 0.01, 0.01, 0.001])
    got = out["cams"].numpy()
    np.testing.assert_array_equal(got[0], cams[0])
    assert np.abs(got[1] - cams[1]).max() > 1e-6
    assert np.abs(got[2] - cams[2]).max() > 1e-6


def test_map_scan_ba_fused_moves_decoder(rng):
    """BA on the fused trunks with a trainable colour decoder: the decoder
    gets real weight gradients although BA renders in tracker mode, and the
    poses move."""
    pt, cams, out = _ba_phase(rng, True, True, 4, [0.01, 0.01, 0.01, 0.001])
    before = tOpt.tree_leaves(pt["col_fine"]["core"])
    after = tOpt.tree_leaves(out["dec"]["col_fine"]["core"])
    assert max(float((a - b).abs().max())
               for a, b in zip(after, before)) > 1e-6
    assert np.abs(out["cams"].numpy()[1:] - cams[1:]).max() > 1e-6


def test_render_rays_dec_wgrads(rng):
    """The fused trunks give the colour decoder's weights a gradient in
    tracker mode too (as BA needs), beside the ray-origin one."""
    jcfg = small_cfg()
    _pj, pt = params_pair(jcfg)
    pt = tOpt.tree_map(lambda x: x.clone().requires_grad_(), pt)
    rcfg = tR.RenderConfig(sample_near_pcl=False, near_end_surface=0.96,
                           far_end_surface=1.04)
    pos, count, geo, col, dirs, d_gt = corner_scene(rng)
    ro = T(np.zeros_like(dirs), True)
    z = np.asarray(jR.S.surface_z_vals(jnp.asarray(d_gt), 5, 0.96, 1.04))
    p = (dirs[:, None] * z[..., None]).reshape(-1, 3)
    D, I = jK.knn(jnp.asarray(p), jnp.asarray(pos), jnp.int32(count), k=8)
    _d, _u, color, _v = tR.render_rays(
        pt, t_cfg(jcfg, fused_mlp=True), rcfg, "color_fine", ro, T(dirs),
        T(d_gt), T(pos), count, T(geo), T(col),
        torch.full((dirs.shape[0],), 0.3), is_tracker=True,
        knn_cache=(T(D), T(I).long()))
    w_out = pt["col_fine"]["core"]["out"]["w"]
    g_w, g_ro = torch.autograd.grad(color.sum(), [w_out, ro],
                                    allow_unused=True)
    assert g_ro.abs().max() > 0
    assert g_w is not None and g_w.abs().max() > 0


# ---------------------------------------------------------------------------
# the whole loop on a TUM RGB-D tree (per-sample mapping: rel-pos colour)

def test_port_runs_tiny_tum_tree_on_cpu(tmp_path, monkeypatch):
    """The port's CLI on configs/TUM_RGBD/freiburg1_desk.yaml over a
    5-frame TUM tree of the synthetic room (48x64, tiny budgets): the
    mapper takes the per-sample path (rel-pos colour, from the config) on
    every mapped frame, and the ATE is finite."""
    import os

    import yaml

    from hpslam_tpu_torch import config as C
    from hpslam_tpu_torch import run as R
    from hpslam_tpu_torch.utils import datasets as tD
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cam = dict(H=48, W=64, fx=45.0, fy=45.0, cx=31.5, cy=23.5)
    syn = tD.Synthetic({"dataset": "synthetic", "seed": 3,
                        "synthetic": {"n_frames": 5, "radius": 1.2},
                        "data": {}, "cam": dict(cam, crop_edge=0)})
    tree = str(tmp_path / "tum")
    tD.write_tum_rgbd(tree, [syn[i] for i in range(5)])
    cfg = C.load_config(os.path.join(root, "configs/TUM_RGBD/"
                                     "freiburg1_desk.yaml"),
                        os.path.join(root, "configs/point_slam.yaml"))
    assert cfg["model"]["encode_rel_pos_in_col"]
    cfg["cam"].update(cam, crop_edge=2, distortion=[0.0] * 5)
    cfg["tracking"].update(pixels=200, iters=6, vis_freq=999,
                           ignore_edge_W=4, ignore_edge_H=4)
    cfg["mapping"].update(pixels=400, pixels_adding=600, iters=10,
                          iters_first=12, geo_iter_first=5,
                          mapping_window_size=4, vis_freq=999,
                          pixels_knn_cache=512)
    cfg["pointcloud"]["initial_capacity"] = 8192
    cfg["verbose"] = False
    path = tmp_path / "tum.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    calls = []
    real = tM.build_pixel_knn_cache

    def spy(*a, **kw):
        calls.append(kw["P"])
        return real(*a, **kw)

    monkeypatch.setattr(tM, "build_pixel_knn_cache", spy)
    results, summary = R.run([str(path), "--input_folder", tree, "--output",
                              str(tmp_path / "out"), "--device", "cpu"])
    assert summary["n_frames"] == 5
    # frames 0 and 4 mapped, one cache per level each
    assert len(calls) == 4
    assert np.isfinite(results["absolute_translational_error.rmse"])
