"""Fused tracker render of the PyTorch port against hpslam_tpu's.

* nicer_fused_trackloss: the port's plain version (autograd backward)
  against the reference's Pallas kernel pair in interpret mode on the CPU:
  depth, var, colour, d rays, d aff, for use_affine on/off and both
  weighting modes.  Tolerance rtol 2e-4 / atol 1e-4 on the forward (the
  Fourier projection reaches ~1e3 rad, where an f32 ulp is 6e-5, and the
  two sides round it differently); the cotangents are held at rtol 2e-4
  and an atol of 5e-4 times their largest magnitude: the distance weight
  1/(d^2+1e-10) enters d rays through its square (the inputs keep every
  neighbour at least 1e-2 from its sample), and each side is up to 2.5e-4
  of that magnitude from a float64 evaluation of the same function.
* The slice as a whole: the port's track_frame with the fused branch
  against its plain dense-cache branch on the same weights, cloud, pixels
  and generator seed (the plain branch is held against hpslam_tpu in
  tests/test_torch_engines.py), with the tolerances of the reference's own
  test (tests/test_engines.py test_track_frame_fused_matches_reference_path:
  rtol / atol 2e-3 on the loss curve, 2e-3 / 2e-4 on the pose).
* The port's union map_scan without the mapping-loss kernel
  (fused_composite off: fused trunks + plain render_union) against the same
  call on the mapping-loss path: same inputs, loss curves and optimised
  features.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpslam_tpu.models import decoder as jDec
from hpslam_tpu.ops import fused_mlp as jFM
from tests import test_engines as jte
from hpslam_tpu_torch import convert
from hpslam_tpu_torch import mapper as tM
from hpslam_tpu_torch import renderer as tR
from hpslam_tpu_torch import tracker as tT
from hpslam_tpu_torch.models import decoder as tDec
from hpslam_tpu_torch.ops import fused_mlp as tFM
from hpslam_tpu_torch.ops import knn as tK
from hpslam_tpu_torch.ops import optim as tOpt


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


def trackloss_inputs(rng, n, S, K, C, r=0.3):
    """Rays toward a wall at ~2 m, S samples each, K cached neighbours per
    sample between 1e-2 and 1.2 r away (some outside the radius, one padded
    slot per sample at the 1e6 sentinel), `has` from these frozen
    distances."""
    ro = rng.normal(0, 0.05, (n, 3))
    rd = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.4, 0.4, n),
                   -np.ones(n)], -1)
    d_gt = rng.uniform(1.8, 2.2, n)
    z = d_gt[:, None] * np.linspace(0.96, 1.04, S)
    pts = ro[:, None] + z[..., None] * rd[:, None]
    u = rng.normal(size=(n, S, K, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    dist = rng.uniform(1e-2, 1.2 * r, (n, S, K, 1))
    cpos = pts[:, :, None] + u * dist
    cpos[:, :, -1] = 1e6
    dd = np.sum((cpos - pts[:, :, None]) ** 2, -1)
    has = (np.sum(dd < r * r, -1) >= 2).astype(np.float64)
    has[:3, 1] = 0.0
    c_gt = rng.uniform(size=(n, 3))
    rowc = np.concatenate([z, d_gt[:, None], c_gt, np.full((n, 1), r * r),
                           has, (d_gt > 0)[:, None].astype(np.float64),
                           cpos.reshape(n, S * K * 3)], 1).astype(np.float32)
    cfeat = rng.normal(0, 0.3, (n, S * K * 2 * C)).astype(np.float32)
    rays = np.concatenate([ro, rd], 1).astype(np.float32)
    aff = np.concatenate([np.eye(3).reshape(1, 9) + 0.05 * rng.normal(
        size=(n, 9)), 0.05 * rng.normal(size=(n, 3))], 1).astype(np.float32)
    return rays, rowc, cfeat, aff


@pytest.mark.parametrize("use_affine,wmode", [(False, 0), (True, 0),
                                              (False, 1), (True, 1)],
                         ids=["sigmoid-dist", "affine-dist", "sigmoid-expo",
                              "affine-expo"])
def test_trackloss_matches_pallas_reference(rng, use_affine, wmode):
    cfg = small_cfg()
    pj = jDec.init_nicer(jax.random.PRNGKey(8), cfg)
    pt = convert.params_from_numpy(jax.tree.map(np.asarray, pj))
    n, S, K, C = 32, 5, 8, cfg.c_dim
    rays, rowc, cfeat, aff = trackloss_inputs(rng, n, S, K, C)
    g_depth = rng.normal(size=(n,)).astype(np.float32)
    g_color = rng.normal(size=(n, 3)).astype(np.float32)
    static = (cfg.n_blocks, cfg.skip, S, K, C, 0.1, wmode, use_affine,
              not use_affine)
    gd, cd = pj["geo_fine"], pj["col_fine"]

    def fj(rays_, aff_):
        return jFM.nicer_fused_trackloss(
            rays_, aff_, jnp.asarray(rowc), jnp.asarray(cfeat),
            tuple(jFM.flatten_core(gd["core"])),
            tuple(jFM.flatten_core(cd["core"])), (gd["B"], cd["B"]), *static)

    (d_j, v_j, c_j), vjp = jax.vjp(fj, jnp.asarray(rays), jnp.asarray(aff))
    drays_j, daff_j = vjp((jnp.asarray(g_depth), jnp.zeros(n),
                           jnp.asarray(g_color)))

    tg, tc = pt["geo_fine"], pt["col_fine"]
    rays_t = torch.tensor(rays, requires_grad=True)
    aff_t = torch.tensor(aff, requires_grad=True)
    d_t, v_t, c_t = tFM.nicer_fused_trackloss(
        rays_t, aff_t, torch.tensor(rowc), torch.tensor(cfeat),
        tFM.flatten_core(tg["core"]), tFM.flatten_core(tc["core"]),
        (tg["B"], tc["B"]), *static)
    assert not v_t.requires_grad
    torch.autograd.backward([d_t, c_t], [torch.tensor(g_depth),
                                         torch.tensor(g_color)])
    for name, a, b in (("depth", d_t, d_j), ("var", v_t, v_j),
                       ("color", c_t, c_j)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=2e-4, atol=1e-4, err_msg=name)
    # an input the function does not read (aff without the affine) has no
    # gradient in autograd: zero, as the reference returns
    daff_t = aff_t.grad if aff_t.grad is not None else torch.zeros(n, 12)
    for name, a, b in (("drays", rays_t.grad, drays_j),
                       ("daff", daff_t, daff_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4,
                                   atol=5e-4 * np.abs(b).max() + 1e-7,
                                   err_msg=name)
    if not use_affine:
        assert not daff_t.any()


def _wall_scene(rng):
    pos, count, geo, col = jte.wall_level(rng)
    return (torch.tensor(np.asarray(pos)), int(count),
            torch.tensor(np.asarray(geo)), torch.tensor(np.asarray(col)))


@pytest.mark.parametrize("expo", [False, True], ids=["plain", "exposure"])
def test_track_frame_fused_matches_plain_path(rng, expo):
    """track_frame's fused branch (nicer_fused_trackloss) against its plain
    dense-cache branch: same weights, cloud, pixels and generator seed."""
    mcfg = small_cfg(encode_exposure=expo)
    params = convert.params_from_numpy(jax.tree.map(
        np.asarray, jDec.init_nicer(jax.random.PRNGKey(0), mcfg)))
    tcfg = tDec.ModelConfig(**dataclasses.asdict(mcfg))
    level = _wall_scene(rng)
    idx = tK.build_tiles(level[0], level[1])
    H, W = 24, 32
    fx = fy = 20.0
    cx, cy = 15.5, 11.5
    jj, ii = np.mgrid[0:H, 0:W]
    dirs0 = np.stack([(ii - cx) / fx, -(jj - cy) / fy,
                      -np.ones_like(ii, float)], -1)
    depth = torch.tensor((2.0 / -dirs0[..., 2]).astype(np.float32))
    color = torch.tensor(rng.uniform(0.2, 0.8, (H, W, 3)).astype(np.float32))
    rqm = torch.full((H, W), 0.4)
    cam_init = torch.tensor([1, 0, 0, 0, 0.04, -0.02, 0.03])

    def run(fused):
        best_cam, _best, losses, _ = tT.track_frame(
            params, tcfg, tR.RenderConfig(sample_near_pcl=False), cam_init,
            torch.Generator().manual_seed(2), color, depth, rqm, rqm,
            torch.arange(H * W), H * W, level, idx, level, idx,
            torch.zeros(8), pixels=200, iters_mid=2, iters_fine=2, W=W,
            fx=fx, fy=fy, cx=cx, cy=cy, cam_lr=0.01, separate_lr=False,
            use_exposure=expo, w_color=0.5, use_color=True,
            handle_dynamic=True, fused_track=fused)
        return best_cam.numpy(), losses.numpy()

    cam_ref, loss_ref = run(False)
    cam_fus, loss_fus = run(True)
    assert np.isfinite(loss_ref).all() and loss_ref.shape == (4,)
    np.testing.assert_allclose(loss_fus, loss_ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(cam_fus, cam_ref, rtol=2e-3, atol=2e-4)


def _map_scan_inputs(rng, cfg):
    """The union-cache fixture of tests/test_torch_engines.py: a wall of
    1600 points 2 m in front of two identical frames."""
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
    u = 8
    cp, uids, Wm, pm, const = tM.build_pixel_union_cache(
        torch.Generator().manual_seed(7), depths,
        torch.eye(4).expand(F, 4, 4).contiguous(),
        torch.arange(H * W).expand(F, H * W).contiguous(),
        torch.full((F,), H * W), torch.full((F, H, W), 0.4),
        tK.build_tiles(pos, count), n_cap, P=128, S=5, k=8, u_max=u, H=H,
        W=W, fx=fx, fy=fy, cx=cx, cy=cy, near_surface=0.96,
        far_surface=1.04, min_nn=2, weighting="distance", colors=colors)
    U = tM.unique_bucket(tM.count_unique(uids), n_cap)
    _uniq, uids_c, _, geo_c, col_c = tM.compact_scene(uids, pos, geo, col, U)
    return depths, cp, tM.pack_union_cache(const, Wm, pm, uids_c), u, \
        torch.cat([geo_c, col_c], 1), F


@pytest.mark.parametrize("expo", [False, True], ids=["sigmoid", "exposure"])
def test_map_scan_fused_trunks_match_maploss_path(rng, expo):
    """The union map_scan on the fused trunks + plain render_union
    (fused_composite off) against the mapping-loss path (fused_composite
    on): the same loss in another order of operations.  Loss curves within
    rtol 1e-3 / atol 1e-4 and features within atol 1e-4 after 12 Adam
    iterations (f32 rounding, carried through Adam)."""
    base = tDec.ModelConfig(**dataclasses.asdict(small_cfg(
        encode_exposure=expo)))
    rcfg = tR.RenderConfig(sample_near_pcl=False, near_end_surface=0.96,
                           far_end_surface=1.04)
    params = tDec.init_nicer(torch.Generator().manual_seed(0), base, "cpu")
    depths, cp, packed, u, feat, F = _map_scan_inputs(rng, base)
    expo_stack = torch.tensor(rng.normal(0, 0.5, (F, 8)).astype(np.float32))
    n_it = 12
    lr = np.tile(np.array([[0.005, 0.03, 0.02, 0.0]], np.float32), (n_it, 1))
    out = []
    for composite in (True, False):
        mcfg = dataclasses.replace(base, fused_mlp=True,
                                   fused_composite=composite)
        op = {"feat": feat.clone(),
              "dec": tOpt.tree_map(torch.clone, params["col_fine"])}
        if expo:
            op["expo_feat"] = expo_stack[F - 1].clone()
        op, _ost, losses = tM.map_scan(
            params, mcfg, rcfg, op, tOpt.init(op),
            torch.Generator().manual_seed(1), depths, cp, packed, u,
            expo_stack, lr, F, "fine", 256, 4, expo, True, 0.1)
        out.append((losses.numpy(), op))
    (l_ref, op_ref), (l_new, op_new) = out
    assert np.isfinite(l_ref).all() and (l_ref[4:, 1] > 0).all()
    np.testing.assert_allclose(l_new, l_ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(op_new["feat"].numpy(),
                               op_ref["feat"].numpy(), atol=1e-4)
    for a, b in zip(tFM.flatten_core(op_new["dec"]["core"]),
                    tFM.flatten_core(op_ref["dec"]["core"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)
