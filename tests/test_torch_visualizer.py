"""Full-frame render_img and the visualiser panels of the PyTorch port (CPU)
against hpslam_tpu's render_img and matplotlib.

render_img runs on identical decoder weights, point level and query radii
at 24x32 with some zero-depth pixels (sample_near_pcl_z) and a ray batch
that does not divide the pixel count (the padding); depth, uncertainty and
colour within rtol 1e-4 / atol 1e-5 (f32 sums ordered differently).  The
cloud has 10 tiles of 128 points, fewer than the probe of 16, so that both
searches are exact and the tile narrowing never enters.  The panels equal
matplotlib's colouring of the same arrays bit for bit.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from hpslam_tpu import renderer as jR  # noqa: E402
from hpslam_tpu.models import decoder as jDec  # noqa: E402
from hpslam_tpu.utils import visualizer as jV  # noqa: E402
from hpslam_tpu_torch import convert  # noqa: E402
from hpslam_tpu_torch import renderer as tR  # noqa: E402
from hpslam_tpu_torch.models import decoder as tDec  # noqa: E402
from hpslam_tpu_torch.utils import panels as P  # noqa: E402
from hpslam_tpu_torch.utils import visualizer as tV  # noqa: E402


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


H, W = 24, 32
FX = FY = 20.0
CX, CY = 15.5, 11.5


def small_cfg(**kw):
    return jDec.ModelConfig(c_dim=8, geo_embed=16, col_embed=8, rel_embed=4,
                            hidden_geo=16, hidden_col=32, **kw)


def corner_depth(dirs):
    """Ray depth to a corner of planes z=-2, x=1.2, y=-1.0."""
    t = np.full(dirs.shape[:-1], np.inf)
    for axis, offset in ((2, -2.0), (0, 1.2), (1, -1.0)):
        d = dirs[..., axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            ti = offset / d
        ok = np.isfinite(ti) & (ti > 0.1)
        t = np.where(ok & (ti < t), ti, t)
    return t


def scene(rng, n_cap=2048, c_dim=8):
    """A 20x20-per-plane corner cloud (1200 points), random features, the
    24x32 view's depth with a block of zero-depth pixels, a query radius
    map, a camera pose slightly off identity."""
    g = np.linspace(-2, 2, 20)
    gx, gy = np.meshgrid(g, g)
    pts = np.concatenate([
        np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, -2.0)], -1),
        np.stack([np.full(gx.size, 1.2), gx.ravel(), gy.ravel()], -1),
        np.stack([gx.ravel(), np.full(gx.size, -1.0), gy.ravel()], -1)])
    pos = np.zeros((n_cap, 3), np.float32)
    pos[:pts.shape[0]] = pts
    geo = rng.normal(0, 0.1, (n_cap, c_dim)).astype(np.float32)
    col = rng.normal(0, 0.1, (n_cap, c_dim)).astype(np.float32)
    jj, ii = np.mgrid[0:H, 0:W]
    dirs = np.stack([(ii - CX) / FX, -(jj - CY) / FY,
                     -np.ones_like(ii, float)], -1)
    depth = corner_depth(dirs).astype(np.float32)
    depth[2:6, 20:28] = 0.0          # batch 1 of 4 at batch size 200
    rq = rng.uniform(0.3, 0.5, (H, W)).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.02, -0.01, 0.03]
    return (pos, pts.shape[0], geo, col), depth, rq, c2w


@pytest.mark.parametrize("stage,fused", [("color_fine", False),
                                         ("color_mid", False),
                                         ("color_fine", True)])
def test_render_img_matches_reference(rng, stage, fused):
    """fused: the port renders through the fused trunk pair (kernel #4's
    plain version here), the reference through its plain trunks."""
    cfg = small_cfg()
    rcfg_j = jR.RenderConfig(near_end_surface=0.96, far_end_surface=1.04)
    rcfg_t = tR.RenderConfig(**dataclasses.asdict(rcfg_j))
    pj = jDec.init_nicer(jax.random.PRNGKey(3), cfg)
    pt = convert.params_from_numpy(jax.tree.map(np.asarray, pj))
    (pos, count, geo, col), depth, rq, c2w = scene(rng)
    outs_j = jV.render_img(pj, cfg, rcfg_j, c2w, H, W, FX, FY, CX, CY,
                           (jnp.asarray(pos), jnp.int32(count),
                            jnp.asarray(geo), jnp.asarray(col)), rq,
                           gt_depth=depth, stage=stage, ray_batch_size=200)
    tcfg = tDec.ModelConfig(**dict(dataclasses.asdict(cfg), fused_mlp=fused))
    outs_t = tV.render_img(pt, tcfg, rcfg_t, c2w, H, W, FX, FY, CX, CY,
                           (torch.tensor(pos), count, torch.tensor(geo),
                            torch.tensor(col)), rq, gt_depth=depth,
                           stage=stage, ray_batch_size=200)
    for name, a, b in zip(("depth", "unc", "color"), outs_t, outs_j):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   np.asarray(b, np.float64), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # the zero-depth block rendered near the cloud, not at 0
    assert (outs_t[0].numpy()[2:6, 20:28] > 0.3).all()


def test_render_img_without_depth_matches_reference(rng):
    """No input depth: every ray samples near the cloud, far bound 10."""
    cfg = small_cfg()
    rcfg_j = jR.RenderConfig()
    pj = jDec.init_nicer(jax.random.PRNGKey(4), cfg)
    pt = convert.params_from_numpy(jax.tree.map(np.asarray, pj))
    (pos, count, geo, col), _depth, rq, c2w = scene(rng)
    outs_j = jV.render_img(pj, cfg, rcfg_j, c2w, H, W, FX, FY, CX, CY,
                           (jnp.asarray(pos), jnp.int32(count),
                            jnp.asarray(geo), jnp.asarray(col)), rq,
                           ray_batch_size=300)
    outs_t = tV.render_img(pt, tDec.ModelConfig(**dataclasses.asdict(cfg)),
                           tR.RenderConfig(**dataclasses.asdict(rcfg_j)),
                           c2w, H, W, FX, FY, CX, CY,
                           (torch.tensor(pos), count, torch.tensor(geo),
                            torch.tensor(col)), rq, ray_batch_size=300)
    for name, a, b in zip(("depth", "unc", "color"), outs_t, outs_j):
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   np.asarray(b, np.float64), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_plasma_table_matches_matplotlib():
    ref = matplotlib.colormaps["plasma"](np.arange(256))[:, :3]
    assert P.PLASMA_U8.shape == (256, 3)
    assert np.abs(P.PLASMA_U8 / 255.0 - ref).max() < 1 / 255


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_panels_match_imshow(rng, dtype):
    """Each depth panel is imshow(cmap='plasma', vmin=0, vmax) to bytes,
    values below 0 and above vmax included; each RGB panel imshow of the
    clipped image to bytes; the grid is [depth row; RGB row]."""
    gt_d = rng.uniform(0.5, 3.0, (H, W)).astype(dtype)
    gt_d[3:7, 4:9] = 0
    depth = (gt_d + rng.normal(0, 0.4, (H, W))).astype(dtype)
    depth[0, :4] = [-0.5, 0.0, gt_d.max(), 9.0]
    gt_c = rng.uniform(0, 1, (H, W, 3)).astype(dtype)
    color = rng.uniform(-0.2, 1.2, (H, W, 3)).astype(dtype)
    grid = P.panel_grid(gt_d, depth, gt_c, color)
    assert grid.shape == (2 * H, 3 * W, 3) and grid.dtype == np.uint8

    res_d = np.abs(gt_d - depth)
    res_d[gt_d == 0] = 0
    res_c = np.abs(gt_c - np.clip(color, 0, 1))
    res_c[gt_d == 0] = 0
    dmax = float(np.max(gt_d))
    fig, ax = plt.subplots()
    try:
        for k, a in enumerate((gt_d, depth, res_d)):
            im = ax.imshow(a, cmap="plasma", vmin=0, vmax=dmax)
            np.testing.assert_array_equal(
                grid[:H, k * W:(k + 1) * W],
                im.to_rgba(a, bytes=True)[..., :3], err_msg=str(k))
        for k, a in enumerate((gt_c, color, res_c)):
            a = np.clip(a, 0, 1)
            im = ax.imshow(a)
            np.testing.assert_array_equal(
                grid[H:, k * W:(k + 1) * W],
                im.to_rgba(a, bytes=True)[..., :3], err_msg=str(k))
    finally:
        plt.close(fig)


def test_panels_png_roundtrip(tmp_path, rng):
    from hpslam_tpu_torch.utils import image_io as IO
    gt_d = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    gt_c = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    path = str(tmp_path / "00005_0009_fine.png")
    P.write_panels(path, gt_d, gt_d * 1.01, gt_c, gt_c)
    np.testing.assert_array_equal(
        IO.read_png(path), P.panel_grid(gt_d, gt_d * 1.01, gt_c, gt_c))


def test_visualizer_gating_and_files(tmp_path, rng):
    """vis writes one panel per level on frames that are multiples of
    freq (or with freq_override), the fine level's rendered image with
    save_rendered_image, and reports each level's residuals."""
    from hpslam_tpu_torch.state import PointLevel
    from hpslam_tpu_torch.utils import image_io as IO
    cfg = small_cfg()
    pt = convert.params_from_numpy(jax.tree.map(
        np.asarray, jDec.init_nicer(jax.random.PRNGKey(3), cfg)))
    (pos, count, geo, col), depth, rq, c2w = scene(rng)
    lv = PointLevel(torch.tensor(pos), torch.zeros((pos.shape[0], 2)),
                    torch.tensor(geo), torch.tensor(col), count)

    class _NPC:
        levels = {"mid": lv, "fine": lv}

    class _Slam:
        mcfg = tDec.ModelConfig(**dataclasses.asdict(cfg))
        device = torch.device("cpu")

    s = _Slam()
    s.H, s.W, s.fx, s.fy, s.cx, s.cy = H, W, FX, FY, CX, CY
    vis_dir = str(tmp_path / "mapping_vis")
    v = tV.Visualizer(5, vis_dir, s,
                      tR.RenderConfig(sample_near_pcl=False), verbose=False)
    color = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    rqd = {"mid": rq, "fine": rq}
    for idx in range(12):
        recs = v.vis(idx, 9, depth, color, c2w, _NPC(), pt, rqd,
                     save_rendered_image=True)
        assert len(recs) == (2 if idx % 5 == 0 else 0)
    assert v.vis(7, 3, depth, color, c2w, _NPC(), pt, rqd,
                 freq_override=True)
    assert sorted(os.listdir(vis_dir)) == [
        f"{i:05d}_{it:04d}_{lvl}.png" for i, it in ((0, 9), (5, 9), (7, 3),
                                                    (10, 9))
        for lvl in ("fine", "mid")]
    img_dir = tmp_path / "rendered_image"
    assert sorted(os.listdir(img_dir)) == [
        "frame_00000.png", "frame_00005.png", "frame_00010.png"]
    assert IO.read_png(str(img_dir / "frame_00005.png")).shape == (H, W, 3)
    assert IO.read_png(os.path.join(vis_dir, "00005_0009_mid.png")).shape \
        == (2 * H, 3 * W, 3)
    rec = v.vis(5, 9, depth, color, c2w, _NPC(), pt, rqd)[1]
    assert rec["level"] == "fine" and rec["idx"] == 5
    d, _u, c = v.vis_value_only(c2w, depth, _NPC(), pt, rq)
    assert rec["depth_l1_m"] == pytest.approx(
        float(np.abs(depth - d)[depth > 0].mean()), rel=1e-6)
    assert np.isfinite(rec["psnr_db"])
