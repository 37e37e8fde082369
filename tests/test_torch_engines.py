"""Renderer, tracker and mapper of the PyTorch port (CPU).

render_rays is compared with hpslam_tpu's on identical weights, clouds and
neighbour sets (rtol 1e-4 / atol 1e-5, f32, sums ordered differently).
track_frame and map_scan are checked as the reference's engines are
(tests/test_engines.py): the pose improves, the pose gradient matches
central differences in float64, the mapping loss falls.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpslam_tpu import renderer as jR
from hpslam_tpu.models import decoder as jDec
from hpslam_tpu.ops import knn as jK
from tests import test_engines as jte
from hpslam_tpu_torch import convert
from hpslam_tpu_torch import mapper as tM
from hpslam_tpu_torch import renderer as tR
from hpslam_tpu_torch import tracker as tT
from hpslam_tpu_torch.models import decoder as tDec
from hpslam_tpu_torch.ops import geometry as tG
from hpslam_tpu_torch.ops import interpolate as tIT
from hpslam_tpu_torch.ops import knn as tK
from hpslam_tpu_torch.ops import optim as tOpt
from hpslam_tpu_torch.ops import sampling as tS


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


def corner_level(rng):
    """The reference's three-plane corner fixture (tests/test_engines.py)."""
    pos, count, geo, col = jte.corner_level(rng)
    return (np.asarray(pos), int(count), np.asarray(geo), np.asarray(col))


@pytest.mark.parametrize("stage,tracker", [("geometry_fine", False),
                                           ("color_fine", False),
                                           ("color_mid", True)])
def test_render_rays_matches_reference(rng, stage, tracker):
    cfg = small_cfg()
    rcfg_j = jR.RenderConfig(sample_near_pcl=False, near_end_surface=0.96,
                             far_end_surface=1.04)
    rcfg_t = tR.RenderConfig(**dataclasses.asdict(rcfg_j))
    pj = jDec.init_nicer(jax.random.PRNGKey(2), cfg)
    pt = convert.params_from_numpy(jax.tree.map(np.asarray, pj))
    pos, count, geo, col = corner_level(rng)
    n = 48
    dirs = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.5, 0.5, n),
                     -np.ones(n)], -1).astype(np.float32)
    ro = np.zeros((n, 3), np.float32)
    d_gt = jte.corner_depth(dirs).astype(np.float32)
    rq = np.full((n,), 0.3, np.float32)
    z = np.asarray(jR.S.surface_z_vals(jnp.asarray(d_gt), 5, 0.96, 1.04))
    p = (ro[:, None] + dirs[:, None] * z[..., None]).reshape(-1, 3)
    D, I = jK.knn(jnp.asarray(p), jnp.asarray(pos), jnp.int32(count), k=8)
    outs_j = jR.render_rays(pj, cfg, rcfg_j, stage, jnp.asarray(ro),
                            jnp.asarray(dirs), jnp.asarray(d_gt),
                            jnp.asarray(pos), jnp.int32(count),
                            jnp.asarray(geo), jnp.asarray(col),
                            jnp.asarray(rq), is_tracker=tracker,
                            knn_cache=(D, I))
    Dt, It = torch.tensor(np.asarray(D)), torch.tensor(np.asarray(I))
    dense = None
    if tracker:
        cat = torch.cat([torch.tensor(geo), torch.tensor(col)], 1)
        dense = (torch.tensor(pos)[It], cat[It])
    outs_t = tR.render_rays(pt, t_cfg(cfg), rcfg_t, stage, torch.tensor(ro),
                            torch.tensor(dirs), torch.tensor(d_gt),
                            torch.tensor(pos), count, torch.tensor(geo),
                            torch.tensor(col), torch.tensor(rq),
                            is_tracker=tracker, knn_cache=(Dt, It),
                            dense_cache=dense)
    for name, a, b in zip(("depth", "unc", "color", "vmask"), outs_t,
                          outs_j):
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   np.asarray(b).astype(np.float64),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_sample_near_pcl_z_and_uniform_z(rng):
    pos, count, _geo, _col = corner_level(rng)
    n = 40
    rd = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.5, 0.5, n),
                   -np.ones(n)], -1).astype(np.float32)
    ro = np.zeros((n, 3), np.float32)
    rq = np.full((n,), 0.3, np.float32)
    zj, invj = jR.sample_near_pcl_z(jnp.asarray(ro), jnp.asarray(rd), 0.3,
                                    4.0, 5, jnp.asarray(pos),
                                    jnp.int32(count), jnp.asarray(rq))
    zt, invt = tR.sample_near_pcl_z(torch.tensor(ro), torch.tensor(rd), 0.3,
                                    4.0, 5, torch.tensor(pos), count,
                                    torch.tensor(rq))
    np.testing.assert_array_equal(invt.numpy(), np.asarray(invj))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-6,
                               atol=1e-6)
    assert (~invt).sum() > n // 2
    np.testing.assert_allclose(
        tS.uniform_z_vals(n, 5, 0.3, 4.0).numpy(),
        np.asarray(jR.S.uniform_z_vals(n, 5, 0.3, 4.0)), rtol=1e-6)


def _fit_corner_feats(rng, cfg, params, steps=80):
    """Fit features on a tiny 24x32 view so the map is informative (as
    test_engines.py: 80 Adam steps at lr 0.05, exact neighbours)."""
    pos, count, geo, col = corner_level(rng)
    H, W, fx, fy, cx, cy = 24, 32, 20.0, 20.0, 15.5, 11.5
    jj, ii = np.mgrid[0:H, 0:W]
    dirs0 = np.stack([(ii - cx) / fx, -(jj - cy) / fy,
                      -np.ones_like(ii, float)], -1).reshape(-1, 3)
    depth = jte.corner_depth(dirs0).reshape(H, W).astype(np.float32)
    rcfg = tR.RenderConfig(sample_near_pcl=False)
    pos_t = torch.tensor(pos)
    ro = torch.zeros((H * W, 3))
    rd = torch.tensor(dirs0.astype(np.float32))
    dg = torch.tensor(depth.reshape(-1))
    rq = torch.full((H * W,), 0.4)
    feats = {"g": torch.tensor(geo), "c": torch.tensor(col)}
    st = tOpt.init(feats)
    z = tS.surface_z_vals(dg, rcfg.N_surface, rcfg.near_end_surface,
                          rcfg.far_end_surface)
    cache = tK.knn((ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3),
                   pos_t, count, k=8)      # rays are fixed: search once
    for _ in range(steps):
        f = tOpt.tree_map(lambda t: t.detach().requires_grad_(), feats)
        d, _, _, m = tR.render_rays(params, cfg, rcfg, "geometry_fine", ro,
                                    rd, dg, pos_t, count, f["g"], f["c"], rq,
                                    knn_cache=cache)
        loss = torch.sum(torch.abs(dg - d) * m)
        g = torch.autograd.grad(loss, [f["g"], f["c"]], allow_unused=True)
        feats, st = tOpt.update({"g": g[0], "c": g[1]}, st, feats, 0.05)
    idx = tK.build_tiles(pos_t, count)
    return (pos_t, count, feats["g"], feats["c"]), idx, depth, (H, W, fx, fy,
                                                                cx, cy)


def test_track_frame_improves_pose(rng):
    cfg = t_cfg(small_cfg())
    params = convert.params_from_numpy(jax.tree.map(
        np.asarray, jDec.init_nicer(jax.random.PRNGKey(0), small_cfg())))
    level, idx, depth, (H, W, fx, fy, cx, cy) = _fit_corner_feats(
        rng, cfg, params)
    color = torch.full((H, W, 3), 0.5)
    rqm = torch.full((H, W), 0.4)
    pool = torch.arange(H * W)
    cam_init = torch.tensor([1, 0, 0, 0, 0.05, -0.03, 0.04])
    best_cam, best_loss, losses, _ = tT.track_frame(
        params, cfg, tR.RenderConfig(sample_near_pcl=False), cam_init,
        torch.Generator().manual_seed(2), color, torch.tensor(depth), rqm,
        rqm, pool, H * W, level, idx, level, idx, torch.zeros(8),
        pixels=200, iters_mid=15, iters_fine=15, W=W, fx=fx, fy=fy, cx=cx,
        cy=cy, cam_lr=0.01, separate_lr=False, use_exposure=False,
        w_color=0.5, use_color=False, handle_dynamic=True)
    best_cam = best_cam.numpy()
    assert np.isfinite(best_cam).all()
    assert float(best_loss) <= float(losses[0]) + 1e-5
    assert float(best_loss) < float(losses[0])
    assert np.linalg.norm(best_cam[4:]) < np.linalg.norm(
        cam_init[4:].numpy())


def test_tracker_pose_gradient_matches_fd(rng):
    """Pose gradient of the tracker-mode interpolation with frozen neighbour
    sets, against central differences, in float64."""
    pos, count, geo, _col = corner_level(rng)
    pos = torch.tensor(pos, dtype=torch.float64)
    geo = torch.tensor(geo, dtype=torch.float64)
    fx = fy = 20.0
    cx, cy = 15.5, 11.5
    n = 40
    i = torch.linspace(5.0, 27.0, n, dtype=torch.float64)
    j = torch.linspace(4.0, 20.0, n, dtype=torch.float64)
    dgt = torch.full((n,), 2.0, dtype=torch.float64)
    cam0 = torch.tensor([1, 0, 0, 0, 0.05, -0.03, 0.04], dtype=torch.float64)

    def sample_pts(cam):
        c2w = tG.get_camera_from_tensor(cam)
        dirs = tG.camera_dirs(i, j, fx, fy, cx, cy)
        rd = dirs @ c2w[:3, :3].T
        z = tS.surface_z_vals(dgt, 5, 0.96, 1.04)
        return (c2w[:3, 3] + rd[:, None] * z[..., None]).reshape(-1, 3)

    D0, I0 = tK.knn(sample_pts(cam0).detach(), pos, count, k=8)
    rqp = torch.full((n * 5,), 2.0, dtype=torch.float64)

    def loss_fn(cam):
        p = sample_pts(cam)
        w, has = tIT.interp_weights(D0, I0, p, pos, rqp, 2, diff_pos=True)
        return torch.sum(tIT.weighted_gather(geo, I0, w, has) ** 2)

    cam = cam0.clone().requires_grad_()
    g = torch.autograd.grad(loss_fn(cam), cam)[0].numpy()
    rng2 = np.random.default_rng(3)
    checked = 0
    for _ in range(4):
        v = rng2.normal(size=7)
        v /= np.linalg.norm(v)
        eps = 1e-6
        vt = torch.tensor(v)
        fd = (float(loss_fn(cam0 + eps * vt))
              - float(loss_fn(cam0 - eps * vt))) / (2 * eps)
        ad = float(np.dot(g, v))
        if max(abs(fd), abs(ad)) < 1e-3:
            continue
        assert abs(fd - ad) < 1e-4 * max(abs(fd), abs(ad)), (fd, ad)
        checked += 1
    assert checked >= 2


def test_map_scan_stage_reduces_loss(rng):
    """One mapping phase (geometry then colour iterations through the
    mapping-loss plain version) lowers both losses."""
    cfg = t_cfg(small_cfg(), fused_mlp=True, fused_composite=True)
    rcfg = tR.RenderConfig(sample_near_pcl=False, near_end_surface=0.96,
                           far_end_surface=1.04)
    gen = torch.Generator().manual_seed(0)
    params = tDec.init_nicer(gen, cfg, "cpu")
    n_cap = 2048
    xs, ys = np.meshgrid(np.linspace(-1.5, 1.5, 40),
                         np.linspace(-1.2, 1.2, 40))
    pts = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, -2.0)], -1)
    pos = torch.zeros((n_cap, 3))
    pos[:pts.shape[0]] = torch.tensor(pts, dtype=torch.float32)
    count = pts.shape[0]
    geo = torch.tensor(rng.normal(0, 0.1, (n_cap, 8)).astype(np.float32))
    col = torch.tensor(rng.normal(0, 0.1, (n_cap, 8)).astype(np.float32))
    H, W, F = 24, 32, 2
    fx = fy = 20.0
    cx, cy = 15.5, 11.5
    jj, ii = np.mgrid[0:H, 0:W]
    dirs = np.stack([(ii - cx) / fx, -(jj - cy) / fy,
                     -np.ones_like(ii, float)], -1)
    depth = torch.tensor((2.0 / -dirs[..., 2]).astype(np.float32))
    colors = torch.tensor(rng.uniform(0.2, 0.8, (H, W, 3)).astype(
        np.float32)).expand(F, H, W, 3).contiguous()
    depths = depth.expand(F, H, W).contiguous()
    c2ws = torch.eye(4).expand(F, 4, 4).contiguous()
    rq = torch.full((F, H, W), 0.4)
    pools = torch.arange(H * W).expand(F, H * W).contiguous()
    pool_lens = torch.full((F,), H * W)
    u = 8
    cp, uids, Wm, pm, const = tM.build_pixel_union_cache(
        torch.Generator().manual_seed(7), depths, c2ws, pools, pool_lens, rq,
        tK.build_tiles(pos, count), n_cap, P=128, S=5, k=8, u_max=u, H=H,
        W=W, fx=fx, fy=fy, cx=cx, cy=cy, near_surface=0.96,
        far_surface=1.04, min_nn=2, weighting="distance", colors=colors)
    assert pm.float().mean() > 0.9
    U = tM.unique_bucket(tM.count_unique(uids), n_cap)
    uniq, uids_c, _, geo_c, col_c = tM.compact_scene(uids, pos, geo, col, U)
    packed = tM.pack_union_cache(const, Wm, pm, uids_c)
    op = {"feat": torch.cat([geo_c, col_c], 1),
          "dec": tOpt.tree_map(torch.clone, params["col_fine"])}
    n_it = 30
    lr = np.tile(np.array([[0.005, 0.03, 0.02, 0.0]], np.float32), (n_it, 1))
    op, ost, losses = tM.map_scan(
        params, cfg, rcfg, op, tOpt.init(op), torch.Generator().manual_seed(1),
        depths, cp, packed, u, torch.zeros((F, 8)), lr, F, "fine", 256, 10,
        False, True, 0.1)
    losses = losses.numpy()
    assert np.isfinite(losses).all() and ost["t"] == n_it
    assert losses[9, 0] < losses[0, 0]
    assert losses[-1, 1] < losses[10, 1]
    assert losses[-1, 1] > 0
    # the colour decoder moved; frozen leaves did not
    assert not torch.equal(op["dec"]["core"]["out"]["w"],
                           params["col_fine"]["core"]["out"]["w"])
    assert torch.equal(op["dec"]["B"], params["col_fine"]["B"])


def test_build_schedule_matches_reference():
    from hpslam_tpu import mapper as jM
    lr_cfg = {b: {s: {"decoders_lr": 1.0, "geometry_mid_lr": 2.0,
                      "geometry_fine_lr": 3.0, "color_lr": 4.0}
                  for s in ("geometry_mid", "color_mid", "geometry_fine",
                            "color_fine")} for b in ("init", "stage")}
    for args in ((600, 0.5, 0.3, False, 200), (200, 0.5, 0.3, True, 80),
                 (7, 0.5, 0.3, False, 2)):
        a = jM.build_schedule(*args, lr_cfg, color_refine=False)
        b = tM.build_schedule(*args, lr_cfg, color_refine=False)
        for lvl in ("mid", "fine"):
            np.testing.assert_array_equal(a[lvl][0], b[lvl][0])
            np.testing.assert_array_equal(a[lvl][1], b[lvl][1])
    for n, base in ((600, 600), (571, 600), (800, 600)):
        assert jM.bucket_iters(n, base) == tM.bucket_iters(n, base)
        assert jM.unique_bucket(n * 100, 1 << 20) == tM.unique_bucket(
            n * 100, 1 << 20)


def test_add_points_matches_reference(rng):
    """Insertion through the tile index (k=1, probe=32): same kept rays,
    same positions, same count (features are drawn from each framework's
    own generator)."""
    from hpslam_tpu import state as jS
    from hpslam_tpu_torch import state as tSt
    pos, count, geo, col = corner_level(rng)
    cap = pos.shape[0]
    B = 300
    ro = np.zeros((B, 3), np.float32)
    rd = np.stack([rng.uniform(-0.7, 0.7, B), rng.uniform(-0.6, 0.6, B),
                   -np.ones(B)], -1).astype(np.float32)
    depth = (jte.corner_depth(rd) * (1 + 0.05 * rng.normal(size=B))
             ).astype(np.float32)
    valid = rng.uniform(size=B) > 0.1
    r_add = np.full((B,), 0.06, np.float32)
    lvl_j = jS.PointLevel(pos=jnp.asarray(pos), normal=jnp.zeros((cap, 2)),
                          geo=jnp.asarray(geo), col=jnp.asarray(col),
                          count=jnp.int32(count))
    idx_j = jK.build_tiles(lvl_j.pos, lvl_j.count)
    new_j, n_j = jS.add_points(lvl_j, idx_j, jax.random.PRNGKey(0),
                               jnp.asarray(ro), jnp.asarray(rd),
                               jnp.asarray(depth), jnp.asarray(valid),
                               jnp.asarray(r_add), 0.96, 1.04, n_add=3)
    lvl_t = convert.level_from_numpy(pos, np.zeros((cap, 2)), geo, col,
                                     count)
    idx_t = tK.build_tiles(lvl_t.pos, lvl_t.count)
    n_t = tSt.add_points(lvl_t, idx_t, torch.Generator().manual_seed(0),
                         torch.tensor(ro), torch.tensor(rd),
                         torch.tensor(depth), torch.tensor(valid),
                         torch.tensor(r_add), 0.96, 1.04, n_add=3)
    assert 0 < n_t < B and n_t == int(n_j)
    assert lvl_t.count == int(new_j.count)
    np.testing.assert_allclose(lvl_t.pos[:lvl_t.count].numpy(),
                               np.asarray(new_j.pos)[:lvl_t.count],
                               rtol=1e-6, atol=1e-6)
    assert torch.all(lvl_t.geo[count:lvl_t.count] != 0)


def test_union_cache_helpers_match_reference(rng):
    from hpslam_tpu import mapper as jM
    cap = 500
    cacheI = rng.integers(0, 300, (3, 20, 8)).astype(np.int32)
    cacheI[0, 0, :3] = cap                  # sentinel padding slots
    pos = rng.normal(size=(cap, 3)).astype(np.float32)
    geo = rng.normal(size=(cap, 4)).astype(np.float32)
    col = rng.normal(size=(cap, 4)).astype(np.float32)
    n_j = int(jM.count_unique(jnp.asarray(cacheI)))
    assert tM.count_unique(torch.tensor(cacheI)) == n_j
    U = 512
    out_j = jM.compact_scene(jnp.asarray(cacheI), jnp.asarray(pos),
                             jnp.asarray(geo), jnp.asarray(col), U)
    out_t = tM.compact_scene(torch.tensor(cacheI).long(), torch.tensor(pos),
                             torch.tensor(geo), torch.tensor(col), U)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # keyframe overlap ranking is the same numpy code on both sides
    depth = np.full((24, 32), 2.0, np.float32)
    poses = [np.eye(4) for _ in range(4)]
    for i, p in enumerate(poses):
        p[0, 3] = 0.2 * i
    a = jM.keyframe_selection_overlap(np.random.default_rng(5), depth,
                                      np.eye(4), poses, 3, 20.0, 20.0, 15.5,
                                      11.5)
    b = tM.keyframe_selection_overlap(np.random.default_rng(5), depth,
                                      np.eye(4), poses, 3, 20.0, 20.0, 15.5,
                                      11.5)
    assert list(a) == list(b)
